"""Generic x-slab sharding for periodic-domain grid solvers.

The hypersonic solver has bespoke inflow/outflow boundary fills
(hypersonic2d_sharded.py); every periodic solver (Gray–Scott, Burgers,
shallow water, LBM, Stam) shares one simpler pattern: exchange `halo`
columns around the device ring with lax.ppermute (the ring IS the periodic
wrap), run the dense local update on the extended slab, crop.

Communication-avoiding composition: because slab-edge corruption creeps
one cell per step (stencil radius 1), `halo=K` with a `local_step` that
runs K dense steps pays ONE ppermute exchange per K steps instead of one
per step — the corrupted region after K steps is exactly the K halo
columns that get cropped.  Equivalence is proven in
tests/test_periodic_sharded.py for the K-step local body.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["exchange_periodic_x", "make_sharded_periodic_run", "shard_arrays"]


def exchange_periodic_x(f: jnp.ndarray, halo: int, axis_name: str,
                        n_devices: int) -> jnp.ndarray:
    """Extend a local slab with `halo` columns from the ring neighbors
    (fully periodic: device 0's left neighbor is device n-1)."""
    left_ghost = lax.ppermute(
        f[..., -halo:], axis_name,
        perm=[(i, (i + 1) % n_devices) for i in range(n_devices)],
    )
    right_ghost = lax.ppermute(
        f[..., :halo], axis_name,
        perm=[(i, (i - 1) % n_devices) for i in range(n_devices)],
    )
    return jnp.concatenate([left_ghost, f, right_ghost], axis=-1)


def shard_arrays(arrays: tuple, mesh: Mesh, axis: str = "x") -> tuple:
    """Place a tuple of (..., nx) arrays with x-slab sharding on `mesh`."""

    def place(a):
        spec = P(*([None] * (a.ndim - 1) + [axis]))
        return jax.device_put(a, NamedSharding(mesh, spec))

    return tuple(place(a) for a in arrays)


def make_sharded_periodic_run(
    local_step: Callable[[tuple], tuple],
    mesh: Mesh,
    halo: int,
    n_steps: int,
    axis: str = "x",
):
    """Build a jitted runner for `n_steps` sharded periodic steps.

    `local_step(extended_arrays) -> updated_extended_arrays` is the dense
    periodic step applied to the halo-extended slab (its built-in periodic
    wrap at the extended edges only corrupts the halo columns, which are
    cropped). All arrays must have x as the last axis and the same nx.
    """
    n_dev = mesh.shape[axis]

    def body(*arrays):
        def one(carry, _):
            ext = tuple(
                exchange_periodic_x(f, halo, axis, n_dev) for f in carry
            )
            out = local_step(ext)
            return tuple(f[..., halo:-halo] for f in out), None

        out, _ = lax.scan(one, tuple(arrays), None, length=n_steps)
        return out

    def spec_for(a_ndim):
        return P(*([None] * (a_ndim - 1) + [axis]))

    def run(arrays: tuple) -> tuple:
        in_specs = tuple(spec_for(a.ndim) for a in arrays)
        sharded = jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=in_specs,
            check_vma=False,
        )
        return jax.jit(sharded)(*arrays)

    return run
