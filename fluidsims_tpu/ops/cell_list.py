"""Fixed-capacity cell lists for particle neighbor search, sort-based.

The reference builds per-cell linked lists with atomicExch
(tau_sph.cu:159-176) and traverses them with data-dependent pointer chasing
(:193-266).  This sort-based replacement needs neither atomics nor
pointer chasing:

  1. cell id per particle (clamped binning, tau_sph.cu:141-157),
  2. argsort particles by cell id (XLA sort),
  3. rank-within-cell from the sorted order,
  4. scatter the sorted indices into a dense (n_cells, capacity) table
     (overflow beyond `capacity` is dropped — see `overflow_count`),
  5. neighbor loops become 9 static gathers of (N, capacity) index blocks,
     masked where slots are empty — fixed shapes, fully vectorized.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

__all__ = ["CellGrid", "CellList", "make_grid", "build_cell_list",
           "cell_of", "overflow_count"]


class CellGrid(NamedTuple):
    Gx: int
    Gy: int
    cell: float       # cell edge length
    capacity: int     # max particles stored per cell


class CellList(NamedTuple):
    table: jnp.ndarray   # (Gx*Gy, capacity) int32 particle indices, N = empty
    cid: jnp.ndarray     # (N,) cell id per particle
    n: int               # particle count (sentinel value)


def make_grid(box_x: float, box_y: float, h: float, capacity: int,
              cell_mul: float = 2.0) -> CellGrid:
    """Grid with cell size 2h so the 3x3 neighborhood covers the kernel
    support (ensure_cell_buffers, tau_sph.cu:512-541)."""
    cell = cell_mul * h
    import math

    Gx = max(1, math.ceil(box_x / cell))
    Gy = max(1, math.ceil(box_y / cell))
    return CellGrid(Gx=Gx, Gy=Gy, cell=cell, capacity=capacity)


def cell_of(grid: CellGrid, pos: jnp.ndarray) -> jnp.ndarray:
    """Clamped cell id per particle (grid_x/grid_y, tau_sph.cu:141-157)."""
    gx = jnp.clip(jnp.floor(pos[:, 0] / grid.cell).astype(jnp.int32), 0,
                  grid.Gx - 1)
    gy = jnp.clip(jnp.floor(pos[:, 1] / grid.cell).astype(jnp.int32), 0,
                  grid.Gy - 1)
    return gy * grid.Gx + gx


def build_cell_list(grid: CellGrid, pos: jnp.ndarray) -> CellList:
    n = pos.shape[0]
    M = grid.Gx * grid.Gy
    K = grid.capacity

    cid = cell_of(grid, pos)
    order = jnp.argsort(cid)
    sorted_cid = cid[order]

    # rank within cell = position among equal cids
    first_same = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    slot = jnp.arange(n, dtype=jnp.int32) - first_same.astype(jnp.int32)

    flat = sorted_cid * K + slot
    flat = jnp.where(slot < K, flat, M * K)  # overflow -> dropped
    table = jnp.full((M * K,), n, dtype=jnp.int32)
    table = table.at[flat].set(order.astype(jnp.int32), mode="drop")
    return CellList(table=table.reshape(M, K), cid=cid, n=n)


def overflow_count(grid: CellGrid, cl: CellList) -> jnp.ndarray:
    """Number of particles that exceeded per-cell capacity (diagnostic)."""
    stored = jnp.sum(cl.table < cl.n)
    return cl.cid.shape[0] - stored


NEIGHBOR_OFFSETS = [(-1, -1), (0, -1), (1, -1),
                    (-1, 0), (0, 0), (1, 0),
                    (-1, 1), (0, 1), (1, 1)]


def neighbor_indices(grid: CellGrid, cl: CellList, ox: int, oy: int):
    """Per-particle neighbor-slot indices for one 3x3 cell offset: returns
    (idx (N, K) int32, valid (N, K) bool). Out-of-grid cells yield no
    neighbors (cell_index -1 guard, tau_sph.cu:135-139)."""
    cidx = cl.cid % grid.Gx
    cidy = cl.cid // grid.Gx
    nx = cidx + ox
    ny = cidy + oy
    in_grid = (nx >= 0) & (nx < grid.Gx) & (ny >= 0) & (ny < grid.Gy)
    ncell = jnp.where(in_grid, ny * grid.Gx + nx, 0)
    idx = cl.table[ncell]                        # (N, K)
    valid = in_grid[:, None] & (idx < cl.n)
    return idx, valid
