"""Spatially-sharded FLIP/APIC: x-slab domain decomposition + migration.

parallel/flip_sharded.py shards only the particle transfers and psums a
REPLICATED grid — per-device memory stays O(n) and the pressure solve is
duplicated on every chip.  This module cuts the DOMAIN instead, the same
decomposition sph_spatial.py applies to SPH (the reference's scale axis
is particle count, 65k -> millions, SURVEY §5):

  * the grid's x columns are cut into D contiguous slabs of W = n/D
    columns; device d OWNS the particles whose base cell column
    (floor(px*(n-1)), the binning cell of solvers/flip_apic._step_dense)
    lies in its slab, in a fixed-capacity sentinel-padded buffer of
    P_cap = slack * particles/D slots, plus the (n, W) grid columns;
  * binning (the packed-sort rank pass of ops/cell_dense.py) runs on
    the local buffer only — O(n/D log n/D) — into a local (n, W, K)
    dense slab;
  * every grid array lives as (n, W + 2*H) with H=3 halo columns.
    P2G partial sums accumulated into a device's halo columns are
    REDUCED into the owning neighbor (a reverse halo exchange over
    lax.ppermute), then mass/momentum halos are FILLED from the owners;
  * the 48-iteration Jacobi pressure solve exchanges an H-wide pressure
    band and runs H iterations per exchange, recomputing the eroding
    halo instead of syncing every sweep (communication-avoiding
    Jacobi: ceil(48/3) = 16 ppermute rounds instead of 48);
  * G2P (including the +-h affine samples, window +-2) reads only the
    filled halos — H=3 covers the widest window;
  * after advection, particles whose new base column crossed a slab
    boundary migrate to the neighbor device through fixed-size
    sentinel-padded ppermute buffers and each buffer recompacts
    (spatial_common.compact), exactly as in sph_spatial.py.

Every stage is per-device O(n/D + n*W) in compute and memory; nothing
is replicated.  Trajectories match the single-chip dense engine to f32
summation-order tolerance (slot order inside a cell follows the local
buffer, and P2G boundary sums merge in a different order), compared by
particle id in tests/test_sharded_particles.py.

Capacity overruns (owner buffer or migration buffer) drop particles and
are counted in `lost` — raise `slack`/`mig_cap` if it ever goes
nonzero.  Cell-capacity overflow keeps the single-chip dense-engine
semantics: particles beyond K sit out the transfers that step (frozen,
then re-binned).

Behavioral spec: tau_flip_apic.cu (see solvers/flip_apic.py for the
per-kernel citations); the decomposition itself has no reference
counterpart (the reference is single-GPU).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import cell_dense as cd
from ..solvers import flip_apic as fa
from ..solvers.flip_apic import _gshift, _w1
from .spatial_common import make_halo_ops, migrate, owner_cap

__all__ = ["SpatialFlipState", "shard_state", "make_sharded_run",
           "gather_state"]

_H = 3          # grid halo columns (covers the +-2 G2P affine window)
_SENT = 2.0     # out-of-box position fill for dead slots


class SpatialFlipState(NamedTuple):
    pos: jnp.ndarray       # (D * P_cap, 2); dead slots hold _SENT
    vel: jnp.ndarray       # (D * P_cap, 2)
    affine_x: jnp.ndarray  # (D * P_cap, 2)
    affine_y: jnp.ndarray  # (D * P_cap, 2)
    ids: jnp.ndarray       # (D * P_cap,) int32 particle id, -1 = empty
    density: jnp.ndarray   # (n, n) int32, x-sharded by owned columns
    lost: jnp.ndarray      # int32: particles dropped to capacity overruns


def _slab_w(cfg, n_dev):
    n = cfg.grid
    if n % n_dev:
        raise ValueError(f"grid={n} not divisible by {n_dev} devices")
    W = n // n_dev
    if W < _H + 1:
        raise ValueError(f"slab width {W} must exceed the halo {_H}")
    return W


def shard_state(state: fa.FlipApicState, cfg: fa.FlipApicConfig,
                mesh: Mesh, axis: str = "x",
                slack: float = 4.0) -> SpatialFlipState:
    """Split a replicated FlipApicState into per-slab owner buffers."""
    n_dev = mesh.shape[axis]
    n = cfg.grid
    W = _slab_w(cfg, n_dev)
    P_cap = owner_cap(cfg.particles, n_dev, slack)

    pos = np.asarray(state.pos)
    fields = [pos, np.asarray(state.vel), np.asarray(state.affine_x),
              np.asarray(state.affine_y)]
    bx = np.clip(np.floor(pos[:, 0] * (n - 1)).astype(np.int32), 0, n - 1)
    owner = bx // W

    dt = np.dtype(cfg.jax_dtype)
    bufs = [np.full((n_dev * P_cap, 2), _SENT if i == 0 else 0.0, dt)
            for i in range(4)]
    ids_g = np.full((n_dev * P_cap,), -1, np.int32)
    lost = 0
    for d in range(n_dev):
        mine = np.nonzero(owner == d)[0]
        if len(mine) > P_cap:
            lost += len(mine) - P_cap
            mine = mine[:P_cap]
        sl = slice(d * P_cap, d * P_cap + len(mine))
        for buf, f in zip(bufs, fields):
            buf[sl] = f[mine]
        ids_g[sl] = mine

    shard = NamedSharding(mesh, P(axis))
    dshard = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    put = lambda a, s: jax.device_put(jnp.asarray(a), s)  # noqa: E731
    return SpatialFlipState(
        pos=put(bufs[0], shard), vel=put(bufs[1], shard),
        affine_x=put(bufs[2], shard), affine_y=put(bufs[3], shard),
        ids=put(ids_g, shard),
        density=put(np.zeros((n, n), np.int32), dshard),
        lost=put(np.asarray(lost, np.int32), rep))


def gather_state(s: SpatialFlipState, n: int):
    """(pos, vel, affine_x, affine_y) in original particle order."""
    ids = np.asarray(s.ids)
    alive = ids >= 0
    outs = []
    for f in (s.pos, s.vel, s.affine_x, s.affine_y):
        a = np.asarray(f)
        out = np.full((n, 2), np.nan, a.dtype)
        out[ids[alive]] = a[alive]
        outs.append(out)
    return tuple(outs)


def _local_steps(cfg, axis, n_dev, n_steps, P_cap, mig_cap,
                 pos, vel, ax, ay, ids, density, lost):
    n = cfg.grid
    W = _slab_w(cfg, n_dev)
    Wp = W + 2 * _H
    K = cfg.capacity
    dt = cfg.dt
    dtype = cfg.jax_dtype
    h = 1.0 / (n - 1)
    d = lax.axis_index(axis)
    x0 = d * W                      # first owned grid/cell column

    # global coordinates of the local columns (pads included)
    gcol = x0 - _H + jnp.arange(Wp)                 # (Wp,) global grid col
    row = jnp.arange(n)
    edge_col = (gcol == 0) | (gcol == n - 1)        # (Wp,)
    edge_row = (row == 0) | (row == n - 1)          # (n,)
    ginterior = ((~edge_row[:, None]) & (~edge_col[None, :])
                 & (gcol >= 0)[None, :] & (gcol <= n - 1)[None, :])

    grid = cd.DenseGrid(Gx=W, Gy=n, cell=1.0, K=K)
    M = n * W

    halo_fill, halo_reduce = make_halo_ops(axis, n_dev, d, W, _H)

    def gview(g, oy, ox):
        """(n, Wp) grid -> (n, W) values at (row+oy, owned_col+ox)."""
        rows = _gshift(g, oy, 0) if oy else g
        return lax.slice_in_dim(rows, _H + ox, _H + ox + W, axis=1)

    def sum4(p):
        return (_gshift(p, 0, -1) + _gshift(p, 0, 1)
                + _gshift(p, -1, 0) + _gshift(p, 1, 0))

    def substep(pos, vel, ax, ay, alive, lost):
        px, py = pos[:, 0], pos[:, 1]
        gxp = px * (n - 1)
        gyp = py * (n - 1)
        bxp = jnp.clip(jnp.floor(gxp).astype(jnp.int32), 0, n - 1)
        byp = jnp.clip(jnp.floor(gyp).astype(jnp.int32), 0, n - 1)
        in_slab = alive & (bxp >= x0) & (bxp < x0 + W)
        cid = jnp.where(in_slab, byp * W + (bxp - x0), M)
        cells = cd.bin_particles(grid, pos, cid=cid)
        ok = cells.ok & in_slab          # cells.ok is meaningless for cid=M

        # ---- ONE stacked scatter into the (n, W, K, 14) dense slab ----
        packed = jnp.stack([
            gxp, gyp, vel[:, 0], vel[:, 1],
            ax[:, 0], ax[:, 1], ay[:, 0], ay[:, 1],
            px, py,
            (px + h) * (n - 1), (px - h) * (n - 1),
            (py + h) * (n - 1), (py - h) * (n - 1),
        ], -1)
        dall = cd.scatter_field(grid, cells, packed)
        dgx, dgy = dall[..., 0], dall[..., 1]
        dvx, dvy = dall[..., 2], dall[..., 3]
        dax = dall[..., 4:6]
        day = dall[..., 6:8]
        dpx, dpy = dall[..., 8], dall[..., 9]
        occf = cells.occ.astype(dtype)

        # per-slot GLOBAL cell coordinates
        ixl = lax.broadcasted_iota(jnp.int32, (n, W, K), 1)
        ix = (ixl + x0).astype(dtype)
        iy = lax.broadcasted_iota(jnp.int32, (n, W, K), 0).astype(dtype)
        mx0 = 1.0 + (ix == 0) + (ix == n - 1)
        my0 = 1.0 + (iy == 0) + (iy == n - 1)

        # ---- P2G into the padded local grid + reverse halo exchange ----
        mass = jnp.zeros((n, Wp), dtype)
        mom_u = jnp.zeros((n, Wp), dtype)
        mom_v = jnp.zeros((n, Wp), dtype)
        for oy in (-1, 0, 1):
            jt = iy + oy
            wy = _w1(dgy - jt) * (my0 if oy == 0 else 1.0)
            ry = (jt - dgy) / (n - 1)
            for ox in (-1, 0, 1):
                it = ix + ox
                wt = _w1(dgx - it) * (mx0 if ox == 0 else 1.0) * wy * occf
                rx = (it - dgx) / (n - 1)
                vvx = dvx + cfg.apic * (dax[..., 0] * rx + day[..., 0] * ry)
                vvy = dvy + cfg.apic * (dax[..., 1] * rx + day[..., 1] * ry)
                pad = ((0, 0), (_H + ox, _H - ox))
                sh = lambda s: jnp.pad(  # noqa: E731
                    _gshift(s, -oy, 0) if oy else s, pad)
                mass = mass + sh(jnp.sum(wt, -1))
                mom_u = mom_u + sh(jnp.sum(wt * vvx, -1))
                mom_v = mom_v + sh(jnp.sum(wt * vvy, -1))

        stackd = halo_reduce(jnp.stack([mass, mom_u, mom_v]))
        stackd = halo_fill(stackd)
        mass, u, v = stackd[0], stackd[1], stackd[2]

        # ---- grid phase on (n, Wp) with global-coordinate masks --------
        has_mass = mass > 1e-8
        u = jnp.where(has_mass, u / jnp.maximum(mass, 1e-8), u)
        v = jnp.where(has_mass, v / jnp.maximum(mass, 1e-8)
                      - cfg.gravity * dt, v)
        u = jnp.where(edge_col[None, :], 0.0, u)
        v = jnp.where(edge_row[:, None], 0.0, v)
        u_prev, v_prev = u, v

        div = jnp.where(
            ginterior,
            -0.5 * (n - 1) * (_gshift(u, 0, 1) - _gshift(u, 0, -1)
                              + _gshift(v, 1, 0) - _gshift(v, -1, 0)),
            0.0)

        # banded Jacobi: _H iterations per pressure-halo exchange
        p = jnp.zeros_like(u)
        iters_left = cfg.jacobi
        while iters_left > 0:
            p = halo_fill(p)
            for _ in range(min(_H, iters_left)):
                p = jnp.where(ginterior, 0.25 * (div + sum4(p)), 0.0)
            iters_left -= _H
        p = halo_fill(p)          # full-width valid p for the projection

        u_proj = jnp.where(
            ginterior,
            u - 0.5 * (_gshift(p, 0, 1) - _gshift(p, 0, -1)) / (n - 1),
            0.0)
        v_proj = jnp.where(
            ginterior,
            v - 0.5 * (_gshift(p, 1, 0) - _gshift(p, -1, 0)) / (n - 1),
            0.0)

        # ---- G2P via halo-filled grid views ---------------------------
        def sample(gu, gv, sx, sy, wxs, wys):
            su = jnp.zeros((n, W, K), dtype)
            sv = jnp.zeros((n, W, K), dtype)
            for oy in wys:
                wy = _w1(sy - (iy + oy))
                for ox in wxs:
                    w = _w1(sx - (ix + ox)) * wy
                    su = su + w * gview(gu, oy, ox)[:, :, None]
                    sv = sv + w * gview(gv, oy, ox)[:, :, None]
            return su, sv

        clipc = lambda a: jnp.clip(a, 0.0, n - 1.001)  # noqa: E731
        cgx, cgy = clipc(dgx), clipc(dgy)
        cxp = clipc(dall[..., 10])
        cxm = clipc(dall[..., 11])
        cyp = clipc(dall[..., 12])
        cym = clipc(dall[..., 13])

        C = (0, 1)
        W5 = (-2, -1, 0, 1, 2)
        new_u, new_v = sample(u_proj, v_proj, cgx, cgy, C, C)
        old_u, old_v = sample(u_prev, v_prev, cgx, cgy, C, C)
        flip_u = dvx + new_u - old_u
        flip_v = dvy + new_v - old_v
        vel_x = (1 - cfg.flip) * new_u + cfg.flip * flip_u
        vel_y = (1 - cfg.flip) * new_v + cfg.flip * flip_v

        ux1, vx1 = sample(u_proj, v_proj, cxp, cgy, W5, C)
        ux0, vx0 = sample(u_proj, v_proj, cxm, cgy, W5, C)
        uy1, vy1 = sample(u_proj, v_proj, cgx, cyp, C, W5)
        uy0, vy0 = sample(u_proj, v_proj, cgx, cym, C, W5)
        nax_x = 0.5 * (ux1 - ux0) / h
        nax_y = 0.5 * (vx1 - vx0) / h
        nay_x = 0.5 * (uy1 - uy0) / h
        nay_y = 0.5 * (vy1 - vy0) / h

        nx_ = dpx + vel_x * dt
        ny_ = dpy + vel_y * dt
        hit_x = (nx_ < 0.01) | (nx_ > 0.99)
        hit_y = (ny_ < 0.01) | (ny_ > 0.99)
        vel_x = jnp.where(hit_x, vel_x * -0.35, vel_x)
        vel_y = jnp.where(hit_y, vel_y * -0.35, vel_y)
        nx_ = jnp.clip(nx_, 0.01, 0.99)
        ny_ = jnp.clip(ny_, 0.01, 0.99)

        dense_out = jnp.stack(
            [nx_, ny_, vel_x, vel_y, nax_x, nax_y, nay_x, nay_y], -1)
        flat = dense_out.reshape(M * K, 8)
        got = flat[jnp.clip(cells.didx, 0, M * K - 1)]
        old = jnp.concatenate([pos, vel, ax, ay], -1)
        out = jnp.where(ok[:, None], got, old)
        return out, lost

    def one(carry, _):
        pos, vel, ax, ay, ids, density_acc, lost = carry
        alive = ids >= 0
        out, lost = substep(pos, vel, ax, ay, alive, lost)

        # ---- migration across slab boundaries -------------------------
        bx_new = jnp.clip(jnp.floor(out[:, 0] * (n - 1)).astype(jnp.int32),
                          0, n - 1)
        owner = bx_new // W
        payload = jnp.concatenate(
            [out, ids[:, None].astype(dtype)], axis=1)
        fill9 = jnp.asarray([_SENT, _SENT, 0, 0, 0, 0, 0, 0, -1], dtype)
        final, ids, lost_delta = migrate(
            payload, owner, alive, axis=axis, d=d, n_dev=n_dev,
            mig_cap=mig_cap, p_cap=P_cap, fill_row=fill9)
        pos = final[:, 0:2]
        vel = final[:, 2:4]
        ax = final[:, 4:6]
        ay = final[:, 6:8]
        lost = (lost + lost_delta).astype(jnp.int32)

        # ---- density raster on owned columns (k_g2p raster analog) ----
        a2 = ids >= 0
        rx_ = jnp.clip((pos[:, 0] * n).astype(jnp.int32), 0, n - 1)
        ry_ = jnp.clip((pos[:, 1] * n).astype(jnp.int32), 0, n - 1)
        cl = rx_ - x0 + _H
        okr = a2 & (cl >= 0) & (cl < Wp)
        flat_r = jnp.where(okr, ry_ * Wp + cl, n * Wp)
        dloc = jnp.zeros(n * Wp, jnp.int32).at[flat_r].add(
            1, mode="drop").reshape(n, Wp)
        dloc = halo_reduce(dloc)
        density_acc = lax.slice_in_dim(dloc, _H, _H + W, axis=1)

        return (pos, vel, ax, ay, ids, density_acc, lost), None

    # `density` arrives already sliced to this device's (n, W) block
    carry, _ = lax.scan(
        one, (pos, vel, ax, ay, ids, density, lost), None,
        length=n_steps)
    pos, vel, ax, ay, ids, density_own, lost = carry
    return pos, vel, ax, ay, ids, density_own, lost


def make_sharded_run(cfg: fa.FlipApicConfig, mesh: Mesh, n_steps: int,
                     axis: str = "x", slack: float = 4.0,
                     mig_cap: int = 0):
    """Build run(SpatialFlipState) -> SpatialFlipState over `mesh`."""
    if cfg.particles >= (1 << 24):
        raise ValueError("particle ids ride the f32 migration payload; "
                         "particles must stay below 2^24")
    n_dev = mesh.shape[axis]
    _slab_w(cfg, n_dev)
    P_cap = owner_cap(cfg.particles, n_dev, slack)
    if mig_cap <= 0:
        mig_cap = max(8, P_cap // 8)

    body = functools.partial(_local_steps, cfg, axis, n_dev, n_steps,
                             P_cap, mig_cap)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(None, axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                   P(None, axis), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: SpatialFlipState) -> SpatialFlipState:
        pos, vel, ax, ay, ids, density, lost = sharded(
            state.pos, state.vel, state.affine_x, state.affine_y,
            state.ids, state.density, state.lost)
        return SpatialFlipState(pos=pos, vel=vel, affine_x=ax,
                                affine_y=ay, ids=ids, density=density,
                                lost=lost)

    return run
