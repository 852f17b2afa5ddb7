"""Element gathers on flattened indices.

XLA lowers multi-dimensional advanced indexing (f[j, i]) to a
multi-index gather; these helpers take the equivalent 1-D gather on the
flattened array instead.  All semi-Lagrangian samplers go through them,
so the gather form is chosen in one place.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["gather2d", "gather3d"]


def gather2d(f: jnp.ndarray, j, i):
    """f[j, i] for integer index arrays of any (matching) shape."""
    ny, nx = f.shape
    flat = (j * nx + i).reshape(-1)
    return jnp.take(f.reshape(-1), flat, axis=0).reshape(j.shape)


def gather3d(f: jnp.ndarray, k, j, i):
    """f[k, j, i] for integer index arrays of any (matching) shape."""
    nz, ny, nx = f.shape
    flat = ((k * ny + j) * nx + i).reshape(-1)
    return jnp.take(f.reshape(-1), flat, axis=0).reshape(k.shape)
