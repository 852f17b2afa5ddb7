"""Cell-dense particle layout: gather-free neighbor interactions.

The first cell-list design (cell_list.py) indexes neighbors per particle,
so every pair interaction needs an (n, capacity) element gather.  This
layout instead bins particles into a dense (Gy, Gx, K) array-of-cells
once per step:

  1. sort by cell id, rank-in-cell -> one scatter per field into (M*K,)
  2. a neighbor CELL's residents are then a pure SHIFT of the dense array
     (lax slicing, zero gathers),
  3. pair interactions are (Gy, Gx, K, K) elementwise blocks — dense
     arithmetic,
  4. per-particle results come back with one small gather per output.

This stands in for the reference's atomicExch linked lists + pointer
chasing (tau_sph.cu:159-266).  Particles beyond the K
capacity of a cell are dropped from the interaction set (capacity is
auto-sized ~3x the mean occupancy; `overflow` reports drops).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["DenseCells", "DenseGrid", "make_dense_grid", "bin_particles",
           "bin_rank", "scatter_field", "gather_result", "shift_cells",
           "NEIGHBOR_OFFSETS_2D"]

NEIGHBOR_OFFSETS_2D = [(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]


class DenseGrid(NamedTuple):
    Gx: int
    Gy: int
    cell: float
    K: int


class DenseCells(NamedTuple):
    didx: jnp.ndarray     # (n,) dense slot per particle (M*K = dropped)
    ok: jnp.ndarray       # (n,) bool: particle stored
    occ: jnp.ndarray      # (Gy, Gx, K) bool: slot occupied
    overflow: jnp.ndarray  # scalar int: dropped particles
    inv: jnp.ndarray      # (M*K,) int32: particle index per slot (n = empty)


def make_dense_grid(box_x: float, box_y: float, h: float, n: int,
                    capacity: int = 0, cell_mul: float = 2.0) -> DenseGrid:
    cell = cell_mul * h
    Gx = max(1, math.ceil(box_x / cell))
    Gy = max(1, math.ceil(box_y / cell))
    if capacity <= 0:
        mean_occ = n * cell * cell / (box_x * box_y)
        capacity = max(16, int(math.ceil(3.0 * mean_occ / 8.0)) * 8)
    return DenseGrid(Gx=Gx, Gy=Gy, cell=cell, K=capacity)


def _cid(grid: DenseGrid, pos):
    gx = jnp.clip(jnp.floor(pos[:, 0] / grid.cell).astype(jnp.int32), 0,
                  grid.Gx - 1)
    gy = jnp.clip(jnp.floor(pos[:, 1] / grid.cell).astype(jnp.int32), 0,
                  grid.Gy - 1)
    return gy * grid.Gx + gx


def bin_particles(grid: DenseGrid, pos, cid=None) -> DenseCells:
    """Bin by position (default) or by a caller-computed flat cell id —
    callers whose stencil bookkeeping depends on an exact base-cell
    definition (e.g. floor(pos * (n-1)) in FLIP/MPM) pass `cid` so the
    binning can never disagree with their weights by an FP ulp."""
    n = pos.shape[0]
    M = grid.Gx * grid.Gy
    K = grid.K

    if cid is None:
        cid = _cid(grid, pos)

    # One packed-key sort replaces argsort + searchsorted: sort
    # (cid << b | idx), then rank-in-cell = position - first-of-segment
    # via a cummax scan.
    idx = jnp.arange(n, dtype=jnp.int32)
    bits = max(1, (n - 1).bit_length())
    if M << bits <= (1 << 31):
        skey = jnp.sort((cid << bits) | idx)
        order = skey & ((1 << bits) - 1)
        sc = skey >> bits
    else:  # packed key would overflow int32; fall back to stable argsort
        order = jnp.argsort(cid).astype(jnp.int32)
        sc = cid[order]
    newseg = jnp.concatenate(
        [jnp.ones((1,), bool), sc[1:] != sc[:-1]])
    first = lax.associative_scan(jnp.maximum, jnp.where(newseg, idx, 0))
    slot = idx - first
    ok_sorted = slot < K
    didx_sorted = jnp.where(ok_sorted, sc * K + slot, M * K)

    # back to particle order
    didx = jnp.zeros(n, jnp.int32).at[order].set(didx_sorted)
    ok = jnp.zeros(n, bool).at[order].set(ok_sorted)

    # inverse map slot -> particle: field transfers gather rows through
    # this one int scatter instead of scattering every field
    inv = jnp.full(M * K, n, jnp.int32).at[didx_sorted].set(
        order.astype(jnp.int32), mode="drop", indices_are_sorted=True,
        unique_indices=True)
    occ = inv < n
    overflow = n - jnp.sum(ok)
    return DenseCells(didx=didx, ok=ok,
                      occ=occ.reshape(grid.Gy, grid.Gx, K),
                      overflow=overflow, inv=inv)


def bin_rank(grid: DenseGrid, pos, cid=None):
    """Lean binning: per-particle rank within its cell, in particle order.

    Same packed-sort + cummax-scan machinery as bin_particles, but skips
    the slot->particle inverse map (one scatter saved) for callers that
    scatter field VALUES directly by (cell, rank) — the cell-sharded SPH
    runners (parallel/sph_sharded.py, sph_spatial.py).
    Returns (rank, ok, overflow) with ok = rank < grid.K.
    """
    n = pos.shape[0]
    M = grid.Gx * grid.Gy
    if cid is None:
        cid = _cid(grid, pos)
    idx = jnp.arange(n, dtype=jnp.int32)
    bits = max(1, (n - 1).bit_length())
    if M << bits <= (1 << 31):
        skey = jnp.sort((cid << bits) | idx)
        order = skey & ((1 << bits) - 1)
        sc = skey >> bits
    else:
        order = jnp.argsort(cid).astype(jnp.int32)
        sc = cid[order]
    newseg = jnp.concatenate([jnp.ones((1,), bool), sc[1:] != sc[:-1]])
    first = lax.associative_scan(jnp.maximum, jnp.where(newseg, idx, 0))
    slot = idx - first
    rank = jnp.zeros(n, jnp.int32).at[order].set(slot, unique_indices=True)
    ok = rank < grid.K
    return rank, ok, n - jnp.sum(ok)


def scatter_field(grid: DenseGrid, cells: DenseCells, f):
    """(n,) or (n, c) particle field -> (Gy, Gx, K[, c]) dense array.
    Implemented as a gather through the slot->particle inverse map (empty
    slots read particle 0 and are masked to zero)."""
    K = grid.K
    n = f.shape[0]
    idx = jnp.minimum(cells.inv, n - 1)
    occ = cells.inv < n
    if f.ndim == 1:
        out = jnp.where(occ, f[idx], 0)
        return out.reshape(grid.Gy, grid.Gx, K)
    out = jnp.where(occ[:, None], f[idx], 0)
    return out.reshape(grid.Gy, grid.Gx, K, f.shape[1])


def gather_result(grid: DenseGrid, cells: DenseCells, dense, fill=0.0):
    """(Gy, Gx, K[, c]) dense result -> (n[, c]) per particle (dropped
    particles get `fill`)."""
    M = grid.Gx * grid.Gy
    K = grid.K
    flat = dense.reshape(M * K, *dense.shape[3:])
    idx = jnp.clip(cells.didx, 0, M * K - 1)
    vals = flat[idx]
    if dense.ndim == 3:
        return jnp.where(cells.ok, vals, fill)
    return jnp.where(cells.ok[:, None], vals, fill)


def grid_shift(a, oy: int, ox: int):
    """(Gy, Gx) grid view at offset: out[j, i] = a[j + oy, i + ox], zeros
    outside the grid (used by the dense P2G/G2P transfer formulations)."""
    n0, n1 = a.shape
    padded = jnp.pad(a, ((max(-oy, 0), max(oy, 0)),
                         (max(-ox, 0), max(ox, 0))))
    y0 = max(-oy, 0) + oy
    x0 = max(-ox, 0) + ox
    return padded[y0:y0 + n0, x0:x0 + n1]


def shift_cells(dense, oy: int, ox: int):
    """Dense array of the (oy, ox)-neighbor cell's residents; out-of-grid
    neighbors produce zeros (callers also mask with shifted `occ`)."""
    out = dense
    if oy:
        pad = [(0, 0)] * out.ndim
        pad[0] = (max(-oy, 0), max(oy, 0))
        out = jnp.pad(out, pad)
        out = lax.slice_in_dim(out, max(oy, 0), max(oy, 0) + dense.shape[0],
                               axis=0)
    if ox:
        pad = [(0, 0)] * out.ndim
        pad[1] = (max(-ox, 0), max(ox, 0))
        out = jnp.pad(out, pad)
        out = lax.slice_in_dim(out, max(ox, 0), max(ox, 0) + dense.shape[1],
                               axis=1)
    return out
