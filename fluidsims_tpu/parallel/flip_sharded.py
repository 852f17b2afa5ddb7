"""Multi-device FLIP/APIC: data-parallel particles + replicated grid.

The reference is single-GPU (SURVEY.md §2); its scale axis for particle
solvers is particle COUNT (65k -> millions), while the grid stays small
(128^2 = 130 KB of velocity/mass fields).  The decomposition therefore
shards PARTICLES over the mesh and REPLICATES the grid:

  * each device runs P2G on its particle shard into a full local grid,
  * one `lax.psum` per transfer merges the partial mass/momentum grids
    (~200 KB/step),
  * the grid phase (normalize, 48-iteration Jacobi, projection) is
    computed redundantly on every device — deterministic, so replicas
    stay bit-identical with zero communication,
  * G2P / integrate / raster are pure per-particle work on the shard.

This is the domain analog of data-parallel training with an all-reduced
"model" (the grid).  An x-slab spatial decomposition would win only when
the grid itself outgrows a chip, which is ~10^4x away at these sizes.

Particles are sharded by STRIDED index (device d owns original indices
d::n_dev, materialized by a host-side interleave permutation) so each
shard samples the whole domain uniformly: per-cell occupancy — and with
it the cell-dense engine's K capacity and compute — drops by ~n_dev per
device.  A contiguous index shard would instead own a spatial band of
the seeded block (init's lattice order) and keep full-density cells.

Cross-chip equivalence is to f32 summation-order tolerance (per-device
partial sums + psum reassociate the reference's single-pass P2G sums),
verified on an 8-device CPU mesh in tests/test_sharded_particles.py.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import flip_apic as fa

__all__ = ["interleave_perm", "shard_state", "make_sharded_run"]


def interleave_perm(n: int, n_dev: int) -> np.ndarray:
    """Permutation putting original indices d::n_dev into contiguous
    block d (so an index-sharded array is spatially well-mixed)."""
    return np.arange(n).reshape(n_dev, -1, order="F").reshape(-1)


def shard_state(state: fa.FlipApicState, mesh: Mesh, axis: str = "p"):
    """Interleave-permute the particles and place them on the mesh;
    the density grid is replicated."""
    n_dev = mesh.shape[axis]
    n = state.pos.shape[0]
    if n % n_dev:
        raise ValueError(f"particles={n} not divisible by {n_dev} devices")
    perm = interleave_perm(n, n_dev)
    psh = NamedSharding(mesh, P(axis, None))
    gsh = NamedSharding(mesh, P())
    return fa.FlipApicState(
        pos=jax.device_put(state.pos[perm], psh),
        vel=jax.device_put(state.vel[perm], psh),
        affine_x=jax.device_put(state.affine_x[perm], psh),
        affine_y=jax.device_put(state.affine_y[perm], psh),
        density=jax.device_put(state.density, gsh),
    )


def _local_steps(cfg_local, axis, n_steps, pos, vel, ax, ay, density):
    reduce = lambda g: lax.psum(g, axis)  # noqa: E731

    def one(carry, _):
        s = fa.FlipApicState(*carry)
        out = fa.step(cfg_local, s, grid_reduce=reduce)
        return tuple(out), None

    carry, _ = lax.scan(one, (pos, vel, ax, ay, density), None,
                        length=n_steps)
    return carry


def make_sharded_run(cfg: fa.FlipApicConfig, mesh: Mesh, n_steps: int,
                     axis: str = "p"):
    """Build a jitted function running `n_steps` particle-sharded steps.
    Input/output states follow `shard_state`'s layout (interleaved
    particle order)."""
    n_dev = mesh.shape[axis]
    if cfg.particles % n_dev:
        raise ValueError(
            f"particles={cfg.particles} not divisible by {n_dev} devices")
    # per-device config: the cell-dense capacity auto-sizes down with the
    # local particle count (interleaved shards thin every cell uniformly).
    cfg_local = replace(cfg, particles=cfg.particles // n_dev)

    body = functools.partial(_local_steps, cfg_local, axis, n_steps)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None),
                   P(axis, None), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: fa.FlipApicState) -> fa.FlipApicState:
        pos, vel, ax, ay, density = sharded(
            state.pos, state.vel, state.affine_x, state.affine_y,
            state.density)
        return fa.FlipApicState(pos=pos, vel=vel, affine_x=ax, affine_y=ay,
                                density=density)

    return run
