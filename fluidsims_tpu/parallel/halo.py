"""Halo exchange for slab-decomposed grids.

The reference's scaling mechanism is shared-memory halo tiling within one
GPU (tau_hypersonic_cuda.cu:849-909); across devices the analog is
`lax.ppermute` neighbor exchange over the mesh axis — ghost columns move
between neighbouring devices each step (NCCL over NVLink on a GPU host).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["exchange_halo_x", "extend_with_halo_x"]


def exchange_halo_x(f: jnp.ndarray, halo: int, axis_name: str, n_devices: int):
    """Return (left_ghost, right_ghost) columns received from the mesh
    neighbors of this device (width `halo` each, shape (..., halo)).

    Boundary devices receive zeros in the outward ghost — callers overwrite
    those with the physical BC fill (inflow / edge replication).
    """
    # left ghost = right edge of the left neighbor: shift data rightward.
    right_edge = f[..., -halo:]
    left_ghost = lax.ppermute(
        right_edge,
        axis_name,
        perm=[(i, i + 1) for i in range(n_devices - 1)],
    )
    # right ghost = left edge of the right neighbor: shift data leftward.
    left_edge = f[..., :halo]
    right_ghost = lax.ppermute(
        left_edge,
        axis_name,
        perm=[(i + 1, i) for i in range(n_devices - 1)],
    )
    return left_ghost, right_ghost


def extend_with_halo_x(
    f: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_devices: int,
    left_fill: jnp.ndarray | None = None,
    right_fill: jnp.ndarray | None = None,
):
    """Concatenate exchanged ghosts onto the local slab along x (last axis).

    `left_fill` / `right_fill` override the outward ghost on the first/last
    device (physical boundary): pass a (..., halo) array, or None to use
    edge replication (the outflow clamp semantics of
    tau_hypersonic_cuda.cu:281-282).
    """
    lg, rg = exchange_halo_x(f, halo, axis_name, n_devices)
    idx = lax.axis_index(axis_name)

    if left_fill is None:
        left_fill = jnp.repeat(f[..., :1], halo, axis=-1)
    if right_fill is None:
        right_fill = jnp.repeat(f[..., -1:], halo, axis=-1)

    lg = jnp.where(idx == 0, left_fill, lg)
    rg = jnp.where(idx == n_devices - 1, right_fill, rg)
    return jnp.concatenate([lg, f, rg], axis=-1)
