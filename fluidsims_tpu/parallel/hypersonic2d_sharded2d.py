"""Multi-device 2-D hypersonic solver on a TWO-dimensional device mesh.

Generalizes hypersonic2d_sharded.py (1-D x-slabs) to an (x, y) device
grid: each device owns an (ny/py, nx/px) block, exchanges width-2 halos
with its four mesh neighbors via lax.ppermute (both directions),
and runs the identical dense step on the doubly-extended block.  Outward
ghosts carry the physical BCs: inflow columns on the x=0 device column,
edge replication elsewhere (the outflow clamp in x, and exactly pad_bc's
y edge clamp — the same halo-extend+crop argument as the 1-D case applies
per axis).  The CFL wavespeed max reduces over BOTH mesh axes with
lax.pmax.  Single- vs multi-chip equivalence is asserted in
tests/test_sharded.py on 2x2, 2x4, and 4x2 meshes.
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

__all__ = ["HALO", "make_mesh_2d", "make_sharded_run", "shard_state"]

HALO = 2


def make_mesh_2d(px: int, py: int) -> Mesh:
    devs = np.asarray(jax.devices()[: px * py]).reshape(py, px)
    return Mesh(devs, axis_names=("y", "x"))


def shard_state(state: h2.Hypersonic2DState, mesh: Mesh):
    field_sh = NamedSharding(mesh, P("y", "x"))
    scalar_sh = NamedSharding(mesh, P())
    U = Cons(*(jax.device_put(f, field_sh) for f in state.U))
    mask = jax.device_put(state.mask, field_sh)
    t = jax.device_put(state.t, scalar_sh)
    return h2.Hypersonic2DState(U=U, mask=mask, t=t)


def _extend2d(f, px, py, left_fill=None):
    """Extend a local (nyl, nxl) block with HALO ghosts on all four sides:
    ppermute ring neighbors inside the mesh, physical fills outward."""
    ix = lax.axis_index("x")
    iy = lax.axis_index("y")

    # x halos
    lg = lax.ppermute(f[:, -HALO:], "x",
                      perm=[(i, i + 1) for i in range(px - 1)])
    rg = lax.ppermute(f[:, :HALO], "x",
                      perm=[(i + 1, i) for i in range(px - 1)])
    if left_fill is None:
        left_fill = jnp.repeat(f[:, :1], HALO, axis=1)
    lg = jnp.where(ix == 0, left_fill, lg)
    rg = jnp.where(ix == px - 1, jnp.repeat(f[:, -1:], HALO, axis=1), rg)
    f = jnp.concatenate([lg, f, rg], axis=1)

    # y halos (on the x-extended block so corners are consistent)
    bg = lax.ppermute(f[-HALO:, :], "y",
                      perm=[(i, i + 1) for i in range(py - 1)])
    tg = lax.ppermute(f[:HALO, :], "y",
                      perm=[(i + 1, i) for i in range(py - 1)])
    bg = jnp.where(iy == 0, jnp.repeat(f[:1, :], HALO, axis=0), bg)
    tg = jnp.where(iy == py - 1, jnp.repeat(f[-1:, :], HALO, axis=0), tg)
    return jnp.concatenate([bg, f, tg], axis=0)


def _local_steps(cfg: h2.Hypersonic2DConfig, px: int, py: int, n_steps: int,
                 U: Cons, mask, t):
    nxl = cfg.nx // px
    nyl = cfg.ny // py
    cfg_ext = replace(cfg, nx=nxl + 2 * HALO, ny=nyl + 2 * HALO)

    ix = lax.axis_index("x")
    infl = e2.prim_to_cons(
        e2.inflow_prim(cfg.gamma, cfg.inflow_mach, cfg.jax_dtype), cfg.gamma
    )

    # inflow reset applies at global column 0 == extended column HALO on
    # the x=0 device column
    col_is_halo = jnp.asarray(
        np.arange(nxl + 2 * HALO) == HALO)[None, :]
    inflow_cols = col_is_halo & (ix == 0)

    def fill(v):
        return jnp.full((nyl, HALO), v, cfg.jax_dtype)

    def reduce_both(v):
        return lax.pmax(lax.pmax(v, "x"), "y")

    def one_step(carry, _):
        U, t = carry
        Ue = Cons(
            rho=_extend2d(U.rho, px, py, fill(infl.rho)),
            mx=_extend2d(U.mx, px, py, fill(infl.mx)),
            my=_extend2d(U.my, px, py, fill(infl.my)),
            E=_extend2d(U.E, px, py, fill(infl.E)),
        )
        me = _extend2d(mask, px, py, jnp.zeros((nyl, HALO), bool))

        out = h2.step(
            cfg_ext,
            h2.Hypersonic2DState(U=Ue, mask=me, t=t),
            inflow_cols=inflow_cols,
            wavespeed_reduce=reduce_both,
        )
        U_new = Cons(*(f[HALO:-HALO, HALO:-HALO] for f in out.U))
        return (U_new, out.t), None

    (U, t), _ = lax.scan(one_step, (U, t), None, length=n_steps)
    return U, mask, t


def make_sharded_run(cfg: h2.Hypersonic2DConfig, mesh: Mesh, n_steps: int):
    px = mesh.shape["x"]
    py = mesh.shape["y"]
    if cfg.nx % px or cfg.ny % py:
        raise ValueError(
            f"grid {cfg.ny}x{cfg.nx} not divisible by mesh {py}x{px}")
    if cfg.nx // px < HALO or cfg.ny // py < HALO:
        raise ValueError("local block thinner than the halo")

    body = functools.partial(_local_steps, cfg, px, py, n_steps)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("y", "x"), P("y", "x"), P()),
        out_specs=(P("y", "x"), P("y", "x"), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: h2.Hypersonic2DState) -> h2.Hypersonic2DState:
        U, mask, t = sharded(state.U, state.mask, state.t)
        return h2.Hypersonic2DState(U=U, mask=mask, t=t)

    return run
