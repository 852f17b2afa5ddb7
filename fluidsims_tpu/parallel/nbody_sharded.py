"""Multi-device N-body graph layout: body-sharded exact all-pairs forces.

The exact engine's O(n^2) repulsion (solvers/nbody_graph._repulsion_exact)
decomposes perfectly: device d computes the pair rows of its body shard
against the replicated position set, so per-device compute is n^2/D while
the only communication is one all-gather of the new positions per step
(n * dims * 4 B — 1 MB at the reference's 131k bodies).  Spring forces use each device's slice of the (static) edge list
with a psum merging the per-device partial accumulations (edges touch
bodies outside the shard).  This is the scaling axis the reference lacks
entirely (SURVEY.md §2: no multi-device support of any kind).

The integration is replicated (cheap elementwise on (n, dims)) so state
stays identical on every device — equivalence vs single-chip is to f32
summation-order tolerance (the edge psum reassociates the spring sums).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import nbody_graph as ng

__all__ = ["shard_state", "make_sharded_run"]


def _pad_edges(edges: np.ndarray, n_dev: int) -> np.ndarray:
    """Pad the edge list to a device multiple with (0, 0) self-edges —
    d = 0 gives zero spring force, and node 0 (the pinned root) ignores
    forces anyway."""
    m = edges.shape[0]
    mp = -(-m // n_dev) * n_dev
    if mp == m:
        return edges
    pad = np.zeros((mp - m, 2), edges.dtype)
    return np.concatenate([edges, pad], 0)


def shard_state(state: ng.GraphLayoutState, mesh: Mesh, axis: str = "b"):
    """Positions/velocities replicated; the edge list sharded."""
    n_dev = mesh.shape[axis]
    rep = NamedSharding(mesh, P())
    esh = NamedSharding(mesh, P(axis, None))
    edges = _pad_edges(np.asarray(state.edges), n_dev)
    return ng.GraphLayoutState(
        pos=jax.device_put(state.pos, rep),
        vel=jax.device_put(state.vel, rep),
        edges=jax.device_put(jnp.asarray(edges), esh),
        steps=jax.device_put(state.steps, rep),
    )


def _local_steps(cfg, axis, n_dev, n_steps, pos, vel, edges, steps):
    n = cfg.n_bodies
    if n % n_dev:
        raise ValueError(f"bodies={n} not divisible by {n_dev} devices")
    n_local = n // n_dev
    idx = lax.axis_index(axis)
    row0 = idx * n_local

    def one(carry, _):
        pos, vel, steps = carry
        pos = pos.at[0].set(0.0)
        vel = vel.at[0].set(0.0)

        # exact pair forces for this device's body rows vs ALL bodies
        zero = jnp.zeros((), row0.dtype)
        shard_pos = lax.dynamic_slice(pos, (row0, zero),
                                      (n_local, pos.shape[1]))
        rep_local = ng._repulsion_exact(
            cfg, pos, rows=shard_pos)
        # spring forces from this device's edge slice, merged across devices
        spring = lax.psum(ng._spring_forces(cfg, pos, edges), axis)

        rep = jnp.zeros_like(pos)
        rep = lax.dynamic_update_slice(rep, rep_local, (row0, zero))
        f = spring + lax.psum(rep, axis)

        v = (vel + f * cfg.dt) * cfg.damping
        speed2 = jnp.sum(v * v, axis=-1, keepdims=True)
        scale = jnp.where(
            speed2 > cfg.max_speed**2,
            cfg.max_speed / jnp.sqrt(jnp.maximum(speed2, 1e-30)),
            1.0,
        )
        v = (v * scale).at[0].set(0.0)
        new_pos = (pos + v * cfg.dt).at[0].set(0.0)
        return (new_pos, v, steps + 1), None

    (pos, vel, steps), _ = lax.scan(one, (pos, vel, steps), None,
                                    length=n_steps)
    return pos, vel, edges, steps


def make_sharded_run(cfg: ng.GraphLayoutConfig, mesh: Mesh, n_steps: int,
                     axis: str = "b"):
    n_dev = mesh.shape[axis]
    body = functools.partial(_local_steps, cfg, axis, n_dev, n_steps)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P()),
        out_specs=(P(), P(), P(axis, None), P()),
        check_vma=False,
    )

    @jax.jit
    def run(state: ng.GraphLayoutState) -> ng.GraphLayoutState:
        pos, vel, edges, steps = sharded(state.pos, state.vel, state.edges,
                                         state.steps)
        return ng.GraphLayoutState(pos=pos, vel=vel, edges=edges,
                                   steps=steps)

    return run
