"""Resident-slab FLIP/APIC engine — an experiment kept with its tests.

Hypothesis: the dense engine is bound by per-step binning (one packed-key
sort, one slab scatter, then the transfers); keeping particles RESIDENT
in the (n, n, K) slab across steps (the slab is the lax.scan carry) means
nothing is re-sorted or re-scattered, and only the particles that cross a
cell boundary per step (~18% at the reference 65k) migrate through a
fixed-capacity buffer.

On the accelerator this repository first targeted it lost to the dense
engine: extracting the few movers needs compactions over ALL slots, which
cost more than the full rebuild they replace.  Its speed on the GPU is not
measured; ROADMAP Queue 3 decides whether the code stays.

The migration scheme:

  * transfers run straight off the resident channels via the shared
    flip_apic._dense_transfers (same math as the dense engine, f32
    summation-order differences only from slot assignment);
  * slots whose particle stays in its cell are updated IN PLACE
    (sequential full-bandwidth writes instead of the dense engine's
    indirected slab materialization);
  * movers are extracted with one front-compaction, ranked within
    their destination cell by one ~mig_cap-key sort (4x fewer keys
    than the dense engine's full-n sort), matched to per-cell free
    slots from a cumsum-built free table, and inserted with one row
    scatter;
  * movers whose destination cell is full wait in a `homeless` buffer
    (frozen, like the dense engine's over-capacity particles) and
    retry every step; homeless-buffer overflow drops particles and is
    counted in `lost`.

Use through run_resident(): flat state is binned once per call,
stepped N times resident, and flattened back (the density raster is
computed once at the end — intermediate rasters are unobservable
through a scan anyway).  Not a `FlipApicConfig.engine` value.

Behavioral spec: tau_flip_apic.cu (per-kernel citations in
solvers/flip_apic.py); the residency scheme is this repository's design
with no reference counterpart (CUDA rebuilds the linked-list grid every
step with atomicExch, tau_sph.cu:165-176 pattern).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import cell_dense as cd
from ..parallel.spatial_common import compact as _compact
from . import flip_apic as fa

__all__ = ["ResidentState", "to_resident", "to_flat", "step_resident",
           "run_resident"]

_CH = 8          # px py vx vy ax0 ax1 ay0 ay1


class ResidentState(NamedTuple):
    slab: jnp.ndarray      # (n, n, K, 8) f32; zeros in empty slots
    ids: jnp.ndarray       # (n, n, K) int32 particle id, -1 = empty
    homeless: jnp.ndarray  # (H_cap, 10) f32: [8 ch, cid, id]; id=-1 empty
    lost: jnp.ndarray      # () int32 dropped to homeless-buffer overflow


def _caps(cfg):
    """Migration-buffer sizes: the measured per-step crossing rate at the
    reference shape is ~18% (max 25%), so 0.35n covers it with margin."""
    mig_cap = max(1024, int(math.ceil(0.35 * cfg.particles / 256.0)) * 256)
    h_cap = max(512, cfg.particles // 16)
    return mig_cap, h_cap


def _grid(cfg):
    return cd.DenseGrid(Gx=cfg.grid, Gy=cfg.grid, cell=1.0,
                        K=cfg.capacity)


def _fill_row(dtype, M):
    return jnp.asarray([0.0] * _CH + [float(M), -1.0], dtype)


def to_resident(cfg: fa.FlipApicConfig, s: fa.FlipApicState) -> ResidentState:
    """Bin a flat state into the resident slab (the dense engine's binning,
    run once per run_resident call instead of once per step)."""
    n = cfg.grid
    K = cfg.capacity
    M = n * n
    dtype = s.pos.dtype
    if cfg.particles >= (1 << 24):
        raise ValueError("particle ids ride f32 channels; particles must "
                         "stay below 2^24")

    px, py = s.pos[:, 0], s.pos[:, 1]
    bxp = jnp.clip(jnp.floor(px * (n - 1)).astype(jnp.int32), 0, n - 1)
    byp = jnp.clip(jnp.floor(py * (n - 1)).astype(jnp.int32), 0, n - 1)
    cid = byp * n + bxp
    cells = cd.bin_particles(_grid(cfg), s.pos, cid=cid)

    packed = jnp.concatenate(
        [s.pos, s.vel, s.affine_x, s.affine_y], -1)          # (np, 8)
    slab = cd.scatter_field(_grid(cfg), cells, packed)       # (n, n, K, 8)
    inv = cells.inv.reshape(n, n, K)
    ids = jnp.where(inv < cfg.particles, inv.astype(jnp.int32), -1)

    # over-capacity particles start in the homeless buffer (frozen until
    # their cell has room), matching the dense engine's overflow handling
    _, h_cap = _caps(cfg)
    rows = jnp.concatenate(
        [packed, cid[:, None].astype(dtype),
         jnp.arange(cfg.particles, dtype=dtype)[:, None]], -1)
    homeless, lost = _compact(rows, ~cells.ok, h_cap, _fill_row(dtype, M))
    return ResidentState(slab=slab, ids=ids, homeless=homeless,
                         lost=lost.astype(jnp.int32))


def to_flat(cfg: fa.FlipApicConfig, r: ResidentState) -> fa.FlipApicState:
    """Flatten back to particle-id order + compute the density raster.
    Particles dropped to buffer overruns (lost > 0, pathological) come
    back as zeros."""
    n = cfg.grid
    n_p = cfg.particles
    dtype = r.slab.dtype

    flat_ids = r.ids.reshape(-1)
    dst = jnp.where(flat_ids >= 0, flat_ids, n_p)
    out = jnp.zeros((n_p, _CH), dtype).at[dst].set(
        r.slab.reshape(-1, _CH), mode="drop")
    hid = r.homeless[:, 9].astype(jnp.int32)
    out = out.at[jnp.where(hid >= 0, hid, n_p)].set(
        r.homeless[:, :_CH], mode="drop")

    pos = out[:, 0:2]
    rx = jnp.clip((pos[:, 0] * n).astype(jnp.int32), 0, n - 1)
    ry = jnp.clip((pos[:, 1] * n).astype(jnp.int32), 0, n - 1)
    density = jnp.zeros(n * n, jnp.int32).at[ry * n + rx].add(1)
    return fa.FlipApicState(pos=pos, vel=out[:, 2:4],
                            affine_x=out[:, 4:6], affine_y=out[:, 6:8],
                            density=density.reshape(n, n))


def step_resident(cfg: fa.FlipApicConfig,
                  r: ResidentState) -> ResidentState:
    n = cfg.grid
    K = cfg.capacity
    M = n * n
    dtype = r.slab.dtype
    h = 1.0 / (n - 1)
    mig_cap, h_cap = _caps(cfg)
    ncand = mig_cap + h_cap
    # destination-rank sort packs (cid, index) into one int key
    kdt = jnp.int32 if ncand <= (1 << 16) and M <= (1 << 14) else jnp.int64
    shift = 1 << 16 if kdt == jnp.int32 else 1 << 32

    occf = (r.ids >= 0).astype(dtype)
    px, py = r.slab[..., 0], r.slab[..., 1]
    # empty slots hold zeros, so every derived coordinate stays finite
    # (occf masks them out of the sums, as in the scatter-built slab)
    gx = px * (n - 1)
    gy = py * (n - 1)
    dense_out = fa._dense_transfers(
        cfg, gx, gy, r.slab[..., 2], r.slab[..., 3],
        r.slab[..., 4:6], r.slab[..., 6:8], px, py,
        (px + h) * (n - 1), (px - h) * (n - 1),
        (py + h) * (n - 1), (py - h) * (n - 1),
        occf)

    # ---- classify: stayers update in place, movers migrate ----------
    bx = jnp.clip(jnp.floor(dense_out[..., 0] * (n - 1)).astype(jnp.int32),
                  0, n - 1)
    by = jnp.clip(jnp.floor(dense_out[..., 1] * (n - 1)).astype(jnp.int32),
                  0, n - 1)
    newcid = by * n + bx
    slotcid = (lax.broadcasted_iota(jnp.int32, (n, n, K), 0) * n
               + lax.broadcasted_iota(jnp.int32, (n, n, K), 1))
    occ = r.ids >= 0
    stay = occ & (newcid == slotcid)
    moved = occ & ~stay

    slab2 = jnp.where(stay[..., None], dense_out, 0.0)
    ids2 = jnp.where(stay, r.ids, -1)

    fill = _fill_row(dtype, M)
    rows = jnp.concatenate(
        [dense_out.reshape(M * K, _CH),
         newcid.reshape(M * K, 1).astype(dtype),
         jnp.where(occ, r.ids, -1).reshape(M * K, 1).astype(dtype)], -1)
    movers, lost_m = _compact(rows, moved.reshape(-1), mig_cap, fill)

    # ---- rank candidates within their destination cell --------------
    cand = jnp.concatenate([movers, r.homeless])             # (ncand, 10)
    alive = cand[:, 9] >= 0.0
    ccid = jnp.where(alive, cand[:, 8].astype(jnp.int32), M)
    iota = jnp.arange(ncand, dtype=kdt)
    key = ccid.astype(kdt) * shift + iota
    sk = jnp.sort(key)
    spos = (sk % shift).astype(jnp.int32)
    scid = (sk // shift).astype(jnp.int32)
    first = jnp.concatenate([jnp.ones(1, bool), scid[1:] != scid[:-1]])
    si = jnp.arange(ncand, dtype=jnp.int32)
    seg0 = lax.associative_scan(jnp.maximum, jnp.where(first, si, 0))
    rank = jnp.zeros(ncand, jnp.int32).at[spos].set(si - seg0)

    # ---- per-cell free-slot table ------------------------------------
    free = ids2.reshape(M, K) < 0
    fr = jnp.cumsum(free.astype(jnp.int32), axis=1) - 1
    n_free = fr[:, -1] + 1
    cell_i = lax.broadcasted_iota(jnp.int32, (M, K), 0)
    k_i = lax.broadcasted_iota(jnp.int32, (M, K), 1)
    tdst = jnp.where(free, cell_i * K + fr, M * K)
    table = jnp.zeros(M * K, jnp.int32).at[tdst.reshape(-1)].set(
        k_i.reshape(-1), mode="drop")

    # ---- insert candidates into free slots ---------------------------
    ccl = jnp.clip(ccid, 0, M - 1)
    ok_ins = alive & (rank < n_free[ccl])
    slot_k = table[jnp.clip(ccl * K + rank, 0, M * K - 1)]
    dst = jnp.where(ok_ins, ccl * K + slot_k, M * K)
    ids3 = ids2.reshape(-1).at[dst].set(
        cand[:, 9].astype(jnp.int32), mode="drop").reshape(n, n, K)
    slab3 = slab2.reshape(-1, _CH).at[dst].set(
        cand[:, :_CH], mode="drop").reshape(n, n, K, _CH)

    homeless2, lost_h = _compact(cand, alive & ~ok_ins, h_cap, fill)
    lost = (r.lost + lost_m + lost_h).astype(jnp.int32)
    return ResidentState(slab=slab3, ids=ids3, homeless=homeless2,
                         lost=lost)


def run_resident(cfg: fa.FlipApicConfig, s: fa.FlipApicState,
                 n_steps: int):
    """Run n_steps on the resident slab; returns (FlipApicState, lost).
    lost > 0 means buffer overruns dropped particles (raise the caps)."""
    from ..core.stepper import scan_steps

    r = to_resident(cfg, s)
    r = scan_steps(lambda st: step_resident(cfg, st), r, n_steps)
    return to_flat(cfg, r), r.lost
