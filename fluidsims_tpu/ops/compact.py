"""Sort-free mask→index compaction.

`lax.top_k` over n² keys lowers to a full variadic sort, and
`jnp.flatnonzero(size=...)` to a cumsum of the whole mask.  This module
compacts the indices of set mask cells with a two-level integer prefix
sum (log-depth associative_scan shift-adds, bandwidth-bound) plus one
scatter — O(n²) work with no sort anywhere.  A general utility for
consumers that need a true index list rather than dense values; no
solver calls it today, and its speed on the GPU is not measured.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["compact_indices"]


def compact_indices(mask: jnp.ndarray, m: int,
                    fill_value: int = 0) -> jnp.ndarray:
    """Flat indices (row-major) of the first `m` set cells of a 2-D
    boolean mask, in ascending order; unused trailing slots hold
    `fill_value`.  Cells past the first `m` are dropped — callers that
    need completeness must check `mask.sum() <= m` themselves (the
    stam2d hybrid lax.conds to a full exact pass in that case).

    Equivalent to jnp.flatnonzero(mask, size=m, fill_value=fill_value)
    but lowered as: per-row exclusive prefix sums + an exclusive scan
    over row totals (both log-depth associative scans in int32, exact)
    and a single n²-element scatter into an (m+1)-slot table whose last
    slot absorbs every non-mask cell and every overflow cell.
    """
    n_r, n_c = mask.shape
    mi = mask.astype(jnp.int32)
    # exclusive within-row prefix: slot of cell (r, c) among its row's
    # set cells
    incl = lax.associative_scan(jnp.add, mi, axis=1)
    within = incl - mi
    # exclusive prefix over row totals: slots consumed by earlier rows
    rowtot = incl[:, -1]
    rowoff = lax.associative_scan(jnp.add, rowtot) - rowtot
    off = within + rowoff[:, None]
    flatidx = jnp.arange(n_r * n_c, dtype=jnp.int32).reshape(n_r, n_c)
    # non-mask cells and overflow cells all land in the dump slot m
    pos = jnp.where(mask, jnp.minimum(off, m), m)
    out = jnp.full((m + 1,), fill_value, jnp.int32)
    out = out.at[pos.reshape(-1)].set(flatidx.reshape(-1))
    return out[:m]
