"""Static-offset neighbor access for stencils.

CUDA kernels read neighbors via index arithmetic with clamping/wrapping
(e.g. tau_hypersonic_cuda.cu:266-313, tau_gray_scott.cu:137-139).  The
array equivalent is whole-array shifted views built from static slices
and edge/wrap padding — pure dataflow XLA can fuse, no gathers.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["shift_clamped", "shift_wrapped", "shift_axis_clamped", "shift_axis_wrapped"]


def shift_axis_clamped(a: jnp.ndarray, d: int, axis: int) -> jnp.ndarray:
    """Return S with S[..., i, ...] = a[..., clip(i+d, 0, n-1), ...].

    Edge-replicated shift: the out-of-range region is filled with the edge
    value, matching the reference's index clamping (y-clamp in
    tau_hypersonic_cuda.cu:271-275, outflow copy-last-column at :281-282).
    """
    if d == 0:
        return a
    axis = axis % a.ndim
    n = a.shape[axis]
    if abs(d) >= n:
        raise ValueError(f"shift {d} exceeds axis size {n}")
    if d > 0:
        body = lax.slice_in_dim(a, d, n, axis=axis)
        edge = lax.slice_in_dim(a, n - 1, n, axis=axis)
        pads = [edge] * d
        return lax.concatenate([body] + pads, dimension=axis)
    body = lax.slice_in_dim(a, 0, n + d, axis=axis)
    edge = lax.slice_in_dim(a, 0, 1, axis=axis)
    pads = [edge] * (-d)
    return lax.concatenate(pads + [body], dimension=axis)


def shift_axis_wrapped(a: jnp.ndarray, d: int, axis: int) -> jnp.ndarray:
    """Return S with S[..., i, ...] = a[..., (i+d) mod n, ...] (periodic).

    Implemented as slice+concat, the same two-piece form jnp.roll lowers
    to, spelled out so every shift in the package has one form."""
    if d == 0:
        return a
    axis = axis % a.ndim
    n = a.shape[axis]
    d = d % n
    if d == 0:
        return a
    hi = lax.slice_in_dim(a, d, n, axis=axis)
    lo = lax.slice_in_dim(a, 0, d, axis=axis)
    return lax.concatenate([hi, lo], dimension=axis)


def shift_clamped(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """2-D edge-clamped shift: S[y, x] = a[clip(y+dy), clip(x+dx)]."""
    return shift_axis_clamped(shift_axis_clamped(a, dy, axis=-2), dx, axis=-1)


def shift_wrapped(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """2-D periodic shift: S[y, x] = a[(y+dy) % H, (x+dx) % W]."""
    return shift_axis_wrapped(shift_axis_wrapped(a, dy, axis=-2), dx, axis=-1)
