"""Multi-chip SPH: cell-block-sharded pair interactions.

SPH has no grid/particle transfer to psum (unlike FLIP/MPM) — its cost IS
the pair interactions.  sph_pairs.py computes them over the flattened
cell axis, so the multi-chip decomposition splits that axis across
devices: each device slices its band of cells (+PAD halo columns each
side) out of the replicated dense layout, runs the SAME density and
forces+integrate passes on it, and the per-device bands are merged with
one psum each (bands are disjoint, so the psum is an all-gather in
disguise; every output column is computed by exactly one device with the
same expressions, so the trajectory on D devices matches the one-device
run to f32 summation order — XLA may order each column's pair sums
differently at another slab width).

Binning and the particle-order gather stay replicated in this first cut
(~40% of the 65k single-chip step); the pair compute — the part that
grows quadratically with density and dominates at scale — is what
shards.  State (pos/vel) is replicated; communication per substep is the
two band psums (~5 MB at 65k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import sph as sph_mod
from . import sph_pairs as sp

__all__ = ["shard_state", "make_sharded_run"]


def shard_state(state: sph_mod.SPHState, mesh: Mesh):
    """SPH state is replicated (the cell axis, not particles, is what
    shards)."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, rep), state)


def _local_steps(cfg, axis, n_dev, n_steps, pos, vel, t, tau,
                 rain_carry, step_idx):
    from ..ops import cell_dense as cd

    grid, PAD = sp.grid_geometry(cfg)
    K, Gx = grid.K, grid.Gx
    G = grid.Gx * grid.Gy
    Gp = G + 2 * PAD
    if G % n_dev:
        raise ValueError(f"{G} cells not divisible by {n_dev} devices")
    W = G // n_dev
    dtype = cfg.jax_dtype
    fill = jnp.asarray([sp.SENTINEL, sp.SENTINEL, 0.0, 0.0], dtype)[:, None]
    d = lax.axis_index(axis)
    col0 = d * W  # window start in padded columns (PAD halo included)
    zero = jnp.zeros((), col0.dtype)

    def substep(pos, vel, dt_sub):
        n = pos.shape[0]
        rank, ok, _ = cd.bin_rank(grid, pos)
        cid = cd._cid(grid, pos)
        iota = jnp.arange(n, dtype=jnp.int32)
        flat = jnp.where(ok, rank * Gp + PAD + cid, K * Gp + iota)
        vals = jnp.concatenate([pos, vel], axis=1)
        dense = jnp.broadcast_to(fill.T, (K * Gp, 4)).at[flat].set(
            vals, mode="drop", unique_indices=True).T.reshape(4, K, Gp)

        win = lax.dynamic_slice(dense, (zero, zero, col0),
                                (4, K, W + 2 * PAD))
        rho_w, pt_w = sp.density(cfg, Gx, PAD, win[:2])

        # disjoint bands -> psum == all-gather
        rp_band = jnp.stack([rho_w, pt_w])
        rp_full = lax.psum(
            lax.dynamic_update_slice(
                jnp.zeros((2, K, G), dtype), rp_band, (zero, zero, d * W)),
            axis)
        rp_pad = jnp.pad(rp_full, ((0, 0), (0, 0), (PAD, PAD)))
        rp_win = lax.dynamic_slice(rp_pad, (zero, zero, col0),
                                   (2, K, W + 2 * PAD))

        out_w = sp.forces_integrate(cfg, Gx, PAD, dt_sub.astype(dtype), win,
                                    rp_win)
        out = lax.psum(
            lax.dynamic_update_slice(
                jnp.zeros((4, K, G), dtype), out_w, (zero, zero, d * W)),
            axis)

        got = out.reshape(4, K * G).T[jnp.where(ok, rank * G + cid, 0)]
        acc0 = jnp.zeros_like(pos)
        if cfg.use_grav:
            acc0 = acc0 + jnp.asarray([0.0, -cfg.gravity], dtype)
        posd, veld = sph_mod._integrate(cfg, pos, vel, acc0, dt_sub)
        pos = jnp.where(ok[:, None], got[:, :2], posd)
        vel = jnp.where(ok[:, None], got[:, 2:], veld)
        return pos, vel

    def one(carry, _):
        pos, vel, t, tau, rain_carry, step_idx = carry
        Ksub = cfg.visc_substeps
        dt_try = t * cfg.dtau
        dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
        dt_sub = jnp.minimum(dt_try, dt_cfl) / Ksub
        dtau_accum = jnp.asarray(0.0, t.dtype)
        t_run = t
        for _ in range(Ksub):
            pos, vel = substep(pos, vel, dt_sub)
            if cfg.rain:
                rain_carry = rain_carry + 0.02 * cfg.n * dt_sub
                nspawn = jnp.minimum(jnp.floor(rain_carry),
                                     sph_mod._RAIN_MAX).astype(jnp.int32)
                rain_carry = rain_carry - nspawn
                pos, vel = sph_mod._rain(cfg, pos, vel, nspawn,
                                         cfg.seed + step_idx)
            dtau_accum = dtau_accum + dt_sub / jnp.maximum(t_run, 1e-9)
            t_run = cfg.t0 * jnp.exp(tau + dtau_accum)
        return (pos, vel, t_run, tau + dtau_accum, rain_carry,
                step_idx + 1), None

    carry, _ = lax.scan(one, (pos, vel, t, tau, rain_carry, step_idx),
                        None, length=n_steps)
    return carry


def make_sharded_run(cfg: sph_mod.SPHConfig, mesh: Mesh, n_steps: int,
                     axis: str = "c"):
    n_dev = mesh.shape[axis]
    body = functools.partial(_local_steps, cfg, axis, n_dev, n_steps)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(),) * 6, out_specs=(P(),) * 6,
        check_vma=False,
    )

    @jax.jit
    def run(state: sph_mod.SPHState) -> sph_mod.SPHState:
        return sph_mod.SPHState(*sharded(*state))

    return run
