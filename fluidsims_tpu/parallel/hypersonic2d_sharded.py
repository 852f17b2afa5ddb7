"""Multi-device 2-D hypersonic solver: x-slab decomposition + halo exchange.

SURVEY.md §5 plan: shard the (ny, nx) grid along x over a 1-D mesh,
`ppermute` width-2 halos (MUSCL ±1 chained through face fluxes + 5-tap
diffusion → total stencil reach 2), `lax.pmax` for the CFL wavespeed — the
cross-chip analog of the reference's two-stage max reduction
(tau_hypersonic_cuda.cu:786-847).

Method: each device extends its slab by HALO=2 exchanged columns, fills the
outward ghosts with the physical BCs (inflow on device 0 — the ghost region
is constant, so reconstruction degenerates to the exact inflow state; edge
replication on the last device, which *is* the outflow clamp of
tau_hypersonic_cuda.cu:281-282), runs the identical dense step on the
extended slab, and crops.  Single-chip and multi-chip runs are numerically
identical (tested to f32 exactness in tests/test_sharded.py).
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import euler2d as e2
from ..ops.euler2d import Cons
from ..solvers import hypersonic2d as h2
from .halo import extend_with_halo_x

__all__ = ["HALO", "make_sharded_run", "shard_state"]

HALO = 2  # stencil reach: MUSCL(1) through face flux chain + diffusion(2)


def shard_state(state: h2.Hypersonic2DState, mesh: Mesh, axis: str = "x"):
    """Place a dense state onto the mesh with x-slab sharding."""
    field_sh = NamedSharding(mesh, P(None, axis))
    scalar_sh = NamedSharding(mesh, P())
    U = Cons(*(jax.device_put(f, field_sh) for f in state.U))
    mask = jax.device_put(state.mask, field_sh)
    t = jax.device_put(state.t, scalar_sh)
    return h2.Hypersonic2DState(U=U, mask=mask, t=t)


def _local_steps(cfg: h2.Hypersonic2DConfig, axis: str, n_dev: int, n_steps: int,
                 U: Cons, mask, t):
    """Body run per-device under shard_map: n_steps of halo-exchange + dense
    step on the extended slab."""
    ny = cfg.ny
    nxl = cfg.nx // n_dev
    nx_ext = nxl + 2 * HALO
    cfg_ext = replace(cfg, nx=nx_ext)

    idx = lax.axis_index(axis)
    infl = e2.prim_to_cons(
        e2.inflow_prim(cfg.gamma, cfg.inflow_mach, cfg.jax_dtype), cfg.gamma
    )

    # Inflow applies at global column 0 == extended column HALO on device 0.
    col_is_halo = jnp.asarray(np.arange(nx_ext) == HALO)[None, :]
    inflow_cols = col_is_halo & (idx == 0)

    def fill(v):
        return jnp.full((ny, HALO), v, cfg.jax_dtype)

    def one_step(carry, _):
        U, t = carry
        # Exchange conserved fields + mask. Device 0's outer ghost is the
        # inflow state; the last device's is edge-replicated (outflow).
        Ue = Cons(
            rho=extend_with_halo_x(U.rho, HALO, axis, n_dev, fill(infl.rho)),
            mx=extend_with_halo_x(U.mx, HALO, axis, n_dev, fill(infl.mx)),
            my=extend_with_halo_x(U.my, HALO, axis, n_dev, fill(infl.my)),
            E=extend_with_halo_x(U.E, HALO, axis, n_dev, fill(infl.E)),
        )
        me = extend_with_halo_x(
            mask, HALO, axis, n_dev, jnp.zeros((ny, HALO), bool)
        )

        s_ext = h2.Hypersonic2DState(U=Ue, mask=me, t=t)
        out = h2.step(
            cfg_ext,
            s_ext,
            inflow_cols=inflow_cols,
            wavespeed_reduce=lambda v: lax.pmax(v, axis),
        )
        U_new = Cons(*(f[:, HALO:-HALO] for f in out.U))
        return (U_new, out.t), None

    (U, t), _ = lax.scan(one_step, (U, t), None, length=n_steps)
    return U, mask, t


def make_sharded_run(cfg: h2.Hypersonic2DConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x"):
    """Build a jitted function running `n_steps` sharded physics steps."""
    n_dev = mesh.shape[axis]
    if cfg.nx % n_dev:
        raise ValueError(f"nx={cfg.nx} not divisible by {n_dev} devices")

    body = functools.partial(_local_steps, cfg, axis, n_dev, n_steps)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P()),
        out_specs=(P(None, axis), P(None, axis), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: h2.Hypersonic2DState) -> h2.Hypersonic2DState:
        U, mask, t = sharded(state.U, state.mask, state.t)
        return h2.Hypersonic2DState(U=U, mask=mask, t=t)

    return run
