"""Spatially-sharded SPH: distributed binning + particle migration.

The first multi-chip SPH (parallel/sph_sharded.py) shards only the pair
compute; binning, the dense layout and the particle state stay
replicated, which caps the speedup (~40% replicated at 65k) and keeps
per-device memory O(n).  This module shards the DOMAIN instead — the
reference's scale axis is particle count, 65k -> millions (SURVEY §5;
tau_sph.cu:165-176 rebuilds its cell grid for exactly that growth):

  * the flat cell axis, re-ordered X-MAJOR (cid = gx*Gy + gy; the pair
    math is layout-agnostic, sph_pairs.grid_geometry transpose=True),
    is cut into D contiguous x-slabs of W = G/D cells;
    device d OWNS the particles inside its slab, in a fixed-capacity
    sentinel-padded local buffer of P_cap = slack * n/D slots.  X-slabs,
    not y-slabs: a settling fluid collapses onto the floor — measured on
    the 16k default, ALL particles sit in the bottom 1/8 of the box by
    frame 40, so an equal-cell y cut degenerates to one device — while
    the pool spreads over the full width, keeping x-slabs balanced;
  * binning (the packed-sort rank pass) runs on the local buffer only —
    O(n/D log n/D) per device — and scatters into a local dense window
    of W + 2*PAD columns, NOT the full grid;
  * the PAD halo columns are filled by a lax.ppermute band exchange with
    the slab neighbors (dense residents before density; rho/pressure
    bands before forces); outer edges keep the sentinel fill;
  * the SAME pair passes (sph_pairs.density / forces_integrate) run per
    device over the local window;
  * after integration, particles whose new cell row crossed a slab
    boundary migrate to the neighbor device through fixed-size
    sentinel-padded ppermute buffers, and each local buffer recompacts
    with a cumsum scatter (no sort).

Every stage is per-device O(n/D) in both compute and memory; nothing is
replicated but the scalar clock.  Capacity overruns (local buffer or
migration buffer) drop particles and are counted in the returned `lost`
scalar — raise `slack`/`mig_cap` if it ever goes nonzero.

Trajectories match the replicated-state runner (sph_sharded.py) to f32
summation-order tolerance: cell residency is identical, but the slot order within a
cell follows the local buffer order, so in-cell reduction order differs
(tests/test_sharded_particles.py compares by particle id).  Rain is not
supported here (its overwrite-oldest-slot semantics are inherently
global); run rain=False.

Sizing `slack`: an equal-cell cut load-balances by VOLUME, not by
particles; the owner buffers need slack >= 1 / (fraction of the slab
axis the fluid occupies).  The default slack=4 holds a pool spanning a
quarter of the width; raise it (or use parallel/sph_sharded.py, the
compute-balanced / memory-replicated complement) when the returned
`lost` counter goes nonzero.  Per-device memory stays
O(slack * n/D + G/D) either way.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from typing import NamedTuple

from ..ops import cell_dense as cd
from ..solvers import sph as sph_mod
from . import sph_pairs as sp
from .spatial_common import make_halo_ops, migrate, owner_cap

__all__ = ["SpatialSPHState", "shard_state", "make_sharded_run",
           "gather_state"]


class SpatialSPHState(NamedTuple):
    pos: jnp.ndarray    # (D * P_cap, 2); sentinel rows = empty slots
    vel: jnp.ndarray    # (D * P_cap, 2)
    ids: jnp.ndarray    # (D * P_cap,) int32 particle id, -1 = empty
    t: jnp.ndarray
    tau: jnp.ndarray
    step_idx: jnp.ndarray
    lost: jnp.ndarray   # int32: particles dropped to capacity overruns


def _geometry(cfg, n_dev):
    # transpose=True: flat order x-major; `grid` below has Gx/Gy swapped,
    # i.e. grid.Gx counts CELL COLUMNS of the transposed layout (= real
    # Gy) — _cid(grid, pos[:, ::-1]) yields cid = gx*Gy + gy
    grid, PAD = sp.grid_geometry(cfg, transpose=True)
    G = grid.Gx * grid.Gy
    W = G // n_dev
    if G % n_dev or W % grid.Gx:
        raise ValueError(
            f"slab width G/D = {G}/{n_dev} must be whole cell columns "
            f"(Gy={grid.Gx}); use a device count that divides "
            f"Gx={grid.Gy}")
    if W < PAD:
        raise ValueError(f"slab width {W} is narrower than the {PAD}-cell "
                         "halo; use fewer devices")
    return grid, PAD, G, W


def shard_state(state: sph_mod.SPHState, cfg: sph_mod.SPHConfig,
                mesh: Mesh, axis: str = "c",
                slack: float = 4.0) -> SpatialSPHState:
    """Split a replicated SPHState into per-slab owner buffers."""
    n_dev = mesh.shape[axis]
    grid, PAD, G, W = _geometry(cfg, n_dev)
    P_cap = owner_cap(cfg.n, n_dev, slack)

    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    # x-major flat cell id on the transposed grid (grid.Gx = real Gy)
    gy = np.clip(np.floor(pos[:, 1] / grid.cell).astype(np.int32), 0,
                 grid.Gx - 1)
    gx = np.clip(np.floor(pos[:, 0] / grid.cell).astype(np.int32), 0,
                 grid.Gy - 1)
    owner = (gx * grid.Gx + gy) // W

    dt = np.dtype(cfg.jax_dtype)
    pos_g = np.full((n_dev * P_cap, 2), sp.SENTINEL, dt)
    vel_g = np.zeros((n_dev * P_cap, 2), dt)
    ids_g = np.full((n_dev * P_cap,), -1, np.int32)
    lost = 0
    for d in range(n_dev):
        mine = np.nonzero(owner == d)[0]
        if len(mine) > P_cap:
            lost += len(mine) - P_cap
            mine = mine[:P_cap]
        sl = slice(d * P_cap, d * P_cap + len(mine))
        pos_g[sl] = pos[mine]
        vel_g[sl] = vel[mine]
        ids_g[sl] = mine

    shard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    put = lambda a, s: jax.device_put(jnp.asarray(a), s)  # noqa: E731
    return SpatialSPHState(
        pos=put(pos_g, shard), vel=put(vel_g, shard),
        ids=put(ids_g, shard),
        t=put(np.asarray(state.t), rep), tau=put(np.asarray(state.tau), rep),
        step_idx=put(np.asarray(state.step_idx), rep),
        lost=put(np.asarray(lost, np.int32), rep))


def gather_state(s: SpatialSPHState, n: int):
    """(pos, vel) in original particle order (testing/rendering)."""
    pos = np.asarray(s.pos)
    vel = np.asarray(s.vel)
    ids = np.asarray(s.ids)
    alive = ids >= 0
    out_p = np.full((n, 2), np.nan, pos.dtype)
    out_v = np.full((n, 2), np.nan, vel.dtype)
    out_p[ids[alive]] = pos[alive]
    out_v[ids[alive]] = vel[alive]
    return out_p, out_v




def _local_steps(cfg, axis, n_dev, n_steps, P_cap, mig_cap,
                 pos, vel, ids, t, tau, step_idx, lost):
    grid, PAD, G, W = _geometry(cfg, n_dev)
    K, Gx = grid.K, grid.Gx
    Wp = W + 2 * PAD
    dtype = cfg.jax_dtype
    fill4 = jnp.asarray([sp.SENTINEL, sp.SENTINEL, 0.0, 0.0], dtype)
    d = lax.axis_index(axis)
    cell_base = d * W                      # first owned flat cell

    # shared slab-halo fill (same slice/perm/edge-fill map as the
    # FLIP/MPM spatial runners)
    halo_exchange, _ = make_halo_ops(axis, n_dev, d, W, PAD)

    def substep(pos, vel, ids, lost, dt_sub):
        alive = ids >= 0
        cid_g = cd._cid(grid, pos[:, ::-1])             # x-major flat cell
        cid_in = jnp.where(alive, cid_g, G)             # dead -> own segment
        rank, okc, _ = cd.bin_rank(grid, pos, cid=cid_in)
        col = cid_g - cell_base + PAD                   # local column
        # out-of-slab stragglers (shouldn't happen, but negative columns
        # would WRAP in the scatter) sit out one substep and re-migrate
        ok = okc & alive & (col >= PAD) & (col < PAD + W)
        iota = jnp.arange(pos.shape[0], dtype=jnp.int32)
        flat = jnp.where(ok, rank * Wp + col, K * Wp + iota)
        vals = jnp.concatenate([pos, vel], axis=1)
        dense = jnp.broadcast_to(fill4[None, :], (K * Wp, 4)).at[flat].set(
            vals, mode="drop", unique_indices=True).T.reshape(4, K, Wp)

        halo_fill = jnp.broadcast_to(
            fill4[:, None, None], (4, K, PAD)).astype(dtype)
        dense = halo_exchange(dense, halo_fill)

        rho_w, pt_w = sp.density(cfg, Gx, PAD, dense[:2])

        rp = jnp.pad(jnp.stack([rho_w, pt_w]), ((0, 0), (0, 0), (PAD, PAD)))
        rp = halo_exchange(rp, jnp.zeros((2, K, PAD), dtype))

        out = sp.forces_integrate(cfg, Gx, PAD, dt_sub.astype(dtype), dense,
                                  rp)

        got = out.reshape(4, K * W).T[
            jnp.where(ok, rank * W + (col - PAD), 0)]
        acc0 = jnp.zeros_like(pos)
        if cfg.use_grav:
            acc0 = acc0 + jnp.asarray([0.0, -cfg.gravity], dtype)
        posd, veld = sph_mod._integrate(cfg, pos, vel, acc0, dt_sub)
        pos = jnp.where(ok[:, None], got[:, :2], posd)
        vel = jnp.where(ok[:, None], got[:, 2:], veld)
        pos = jnp.where(alive[:, None], pos, sp.SENTINEL)
        vel = jnp.where(alive[:, None], vel, 0.0)

        # ---- migration: particles whose new column left this slab -----
        cid_new = cd._cid(grid, pos[:, ::-1])
        owner = cid_new // W
        payload = jnp.concatenate(
            [pos, vel, ids[:, None].astype(dtype)], axis=1)
        fill5 = jnp.concatenate([fill4, jnp.asarray([-1.0], dtype)])
        final, ids, lost_delta = migrate(
            payload, owner, alive, axis=axis, d=d, n_dev=n_dev,
            mig_cap=mig_cap, p_cap=P_cap, fill_row=fill5)
        pos = final[:, :2]
        vel = final[:, 2:4]
        lost = (lost + lost_delta).astype(jnp.int32)
        return pos, vel, ids, lost

    def one(carry, _):
        pos, vel, ids, t, tau, step_idx, lost = carry
        Ksub = cfg.visc_substeps
        dt_try = t * cfg.dtau
        dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
        dt_sub = jnp.minimum(dt_try, dt_cfl) / Ksub
        dtau_accum = jnp.asarray(0.0, t.dtype)
        t_run = t
        for _k in range(Ksub):
            pos, vel, ids, lost = substep(pos, vel, ids, lost, dt_sub)
            dtau_accum = dtau_accum + dt_sub / jnp.maximum(t_run, 1e-9)
            t_run = cfg.t0 * jnp.exp(tau + dtau_accum)
        return (pos, vel, ids, t_run, tau + dtau_accum, step_idx + 1,
                lost), None

    carry, _ = lax.scan(
        one, (pos, vel, ids, t, tau, step_idx, lost), None, length=n_steps)
    return carry


def make_sharded_run(cfg: sph_mod.SPHConfig, mesh: Mesh, n_steps: int,
                     axis: str = "c", slack: float = 4.0,
                     mig_cap: int = 0):
    """Build run(SpatialSPHState) -> SpatialSPHState over `mesh`."""
    if cfg.rain:
        raise ValueError("spatial SPH sharding requires rain=False "
                         "(overwrite-oldest rain is global; see module "
                         "docstring)")
    if cfg.use_xsph:
        raise ValueError("the cell-sharded SPH pair path does not "
                         "implement XSPH")
    if cfg.n >= (1 << 24):
        raise ValueError("particle ids ride the f32 migration payload; "
                         "n must stay below 2^24")
    n_dev = mesh.shape[axis]
    P_cap = owner_cap(cfg.n, n_dev, slack)
    if mig_cap <= 0:
        mig_cap = max(8, P_cap // 8)

    body = functools.partial(_local_steps, cfg, axis, n_dev, n_steps,
                             P_cap, mig_cap)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: SpatialSPHState) -> SpatialSPHState:
        return SpatialSPHState(*sharded(*state))

    return run
