"""Force-directed layout of the prime/divisor graph (2-D and 3-D N-body).

Behavioral spec: number_fluid2d.c / number_fluid3d.c — despite their names
these are not fluid solvers (SURVEY.md §0): they are multithreaded
Barnes–Hut force-directed layouts of the graph whose edges connect a root
to every prime and every number to its multiples (generate_edges,
number_fluid2d.c:209-242); spring forces k=0.0125 toward link length 20
with softening 4 (:493-511); BH repulsion 180*m/d^2 with MAC theta=0.75
(:386-438); damped (0.86) velocity integration with speed clamp 80 and
dt=0.5, root pinned at the origin (:515-539, :469-476); circle /
Fibonacci-sphere inits of radius 20*sqrt(n) (:356-368,
number_fluid3d.c:384-404).

Design — the two CPU-parallel structures are replaced by array
equivalents:
  * per-worker force accumulators merged at integrate (:485-523) become a
    single `segment_sum` over the edge list;
  * the pointer-chasing Barnes–Hut quadtree/octree (:244-354) is not
    ported at all: the DEFAULT engine computes the EXACT all-pairs
    repulsion in chunked dense blocks (_repulsion_exact) — ~150 GFLOP at
    the reference's 131k bodies, which an accelerator affords every step,
    so the force error is exactly zero (strictly inside any theta MAC).
    engine="grid" keeps the uniform-grid monopole approximation
    (_repulsion_grid) for scales where O(n^2) finally loses.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
from jax import lax
import numpy as np

from ..core.config import BaseConfig

__all__ = ["GraphLayoutConfig", "GraphLayoutState", "generate_edges", "init",
           "init_arrays", "step", "run"]


def generate_edges(max_number: int) -> np.ndarray:
    """Sieve of Eratosthenes edge list: root(0) -> primes, n -> multiples
    (generate_edges, number_fluid2d.c:209-242). Node i represents number
    i+1."""
    prime = np.ones(max_number + 1, bool)
    prime[:2] = False
    for p in range(2, int(max_number**0.5) + 1):
        if prime[p]:
            prime[p * p:: p] = False

    edges = []
    ns = np.arange(2, max_number + 1)
    pr = ns[prime[2:]]
    edges.append(np.stack([np.zeros_like(pr), pr - 1], -1))
    for frm in range(2, max_number + 1):
        tos = np.arange(2 * frm, max_number + 1, frm)
        if tos.size:
            edges.append(
                np.stack([np.full_like(tos, frm - 1), tos - 1], -1)
            )
    return np.concatenate(edges, 0).astype(np.int32)


@dataclass(frozen=True)
class GraphLayoutConfig(BaseConfig):
    max_number: int = 1 << 17
    dims: int = 2                  # 2 or 3
    link_length: float = 20.0
    spring_k: float = 0.0125
    softening: float = 4.0
    repulsion: float = 180.0
    damping: float = 0.86
    dt: float = 0.5
    max_speed: float = 80.0
    grid_res: int = 32             # monopole mesh resolution per axis
    near_field_max: int = 1 << 15  # grid mode: above this, monopole-only
    # repulsion engine: "exact" = chunked all-pairs (O(n^2) but only
    # ~150 GFLOP at the reference's 131k bodies, and EXACT, i.e. strictly
    # more accurate than the reference's theta=0.75 Barnes-Hut); "grid" =
    # the grid-monopole approximation (for very large n)
    engine: str = "exact"
    chunk: int = 1024              # bodies per all-pairs chunk
    dtype: str = "float32"

    def validate(self):
        self._require(self.max_number >= 2, "max_number >= 2")
        self._require(self.dims in (2, 3), "dims must be 2 or 3")
        self._require(self.grid_res >= 4, "grid_res >= 4")
        self._require(self.engine in ("exact", "grid"),
                      "engine must be exact or grid")

    @property
    def n_bodies(self):
        return self.max_number


class GraphLayoutState(NamedTuple):
    pos: jnp.ndarray    # (n, dims)
    vel: jnp.ndarray
    edges: jnp.ndarray  # (m, 2) int32 — static graph
    steps: jnp.ndarray


def init_arrays(cfg: GraphLayoutConfig):
    """NumPy (pos, vel, edges) for init — shared by the JAX state builder
    and the native engine (which must not touch the device)."""
    n = cfg.n_bodies
    radius = math.sqrt(n) * 20.0
    if cfg.dims == 2:
        a = 2.0 * np.pi * (np.arange(1, n) - 1) / max(n - 1, 1)
        pos = np.zeros((n, 2))
        pos[1:, 0] = np.cos(a) * radius
        pos[1:, 1] = np.sin(a) * radius
    else:
        # Fibonacci sphere (init_bodies_sphere, number_fluid3d.c:384-404)
        golden = np.pi * (3.0 - math.sqrt(5.0))
        k = np.arange(n - 1)
        m = n - 1
        t = k / max(m - 1, 1)
        yy = 1.0 - 2.0 * t
        r = np.sqrt(np.maximum(0.0, 1.0 - yy * yy))
        phi = golden * k
        pos = np.zeros((n, 3))
        pos[1:, 0] = np.cos(phi) * r * radius
        pos[1:, 1] = yy * radius
        pos[1:, 2] = np.sin(phi) * r * radius

    return pos, np.zeros((n, cfg.dims)), generate_edges(cfg.max_number)


def init(cfg: GraphLayoutConfig) -> GraphLayoutState:
    pos, vel, edges = init_arrays(cfg)
    dt = cfg.jax_dtype
    return GraphLayoutState(
        pos=jnp.asarray(pos, dt),
        vel=jnp.asarray(vel, dt),
        edges=jnp.asarray(edges),
        steps=jnp.asarray(0, jnp.int32),
    )


def _spring_forces(cfg, pos, edges):
    """Edge springs with scatter-add accumulation (worker_step,
    number_fluid2d.c:493-511); the root (node 0) receives no spring force.
    Takes the edge array as data — the multi-chip runner
    (parallel/nbody_sharded.py) calls this on its per-device edge shard
    and psums.  The single-chip step uses _spring_forces_static instead:
    the graph is static, so its sorted incidence can be baked in at trace
    time and the two scatter-adds per step become one sorted
    segment_sum."""
    src = edges[:, 0]
    dst = edges[:, 1]
    d = pos[dst] - pos[src]
    d2 = jnp.sum(d * d, axis=-1) + cfg.softening
    inv_d = 1.0 / jnp.sqrt(d2)
    dist = d2 * inv_d
    f = (cfg.spring_k * (dist - cfg.link_length) * inv_d)[:, None] * d

    n = pos.shape[0]
    zero = jnp.zeros_like(pos)
    f_src = jnp.where((src != 0)[:, None], f, 0.0)
    f_dst = jnp.where((dst != 0)[:, None], -f, 0.0)
    out = zero.at[src].add(f_src)
    out = out.at[dst].add(f_dst)
    return out


@functools.lru_cache(maxsize=8)
def _sorted_incidence(max_number: int):
    """Static (target, other-endpoint) incidence of the prime/divisor
    graph, root entries dropped (node 0 receives no spring force), sorted
    by target node.  Computed once per max_number at trace time."""
    e = generate_edges(max_number)
    tgt = np.concatenate([e[:, 0], e[:, 1]])
    oth = np.concatenate([e[:, 1], e[:, 0]])
    keep = tgt != 0
    tgt, oth = tgt[keep], oth[keep]
    order = np.argsort(tgt, kind="stable")
    return tgt[order], oth[order]


def _spring_forces_static(cfg, pos):
    """Single-chip spring forces over the statically-sorted incidence:
    the spring formula is antisymmetric in the endpoints, so evaluating
    it per (target, other) entry yields the correctly-signed contribution
    for both directions of an edge, and one segment_sum with sorted ids
    replaces _spring_forces' two unsorted scatter-adds (measured 8.05 ->
    8.80 steps/s on the 131k-node exact bench; values match up to f32
    reassociation of the per-node sum order)."""
    import jax

    tgt_np, oth_np = _sorted_incidence(cfg.max_number)
    tgt = jnp.asarray(tgt_np)
    oth = jnp.asarray(oth_np)
    d = pos[oth] - pos[tgt]
    d2 = jnp.sum(d * d, axis=-1) + cfg.softening
    inv_d = 1.0 / jnp.sqrt(d2)
    dist = d2 * inv_d
    f = (cfg.spring_k * (dist - cfg.link_length) * inv_d)[:, None] * d
    return jax.ops.segment_sum(f, tgt, num_segments=pos.shape[0],
                               indices_are_sorted=True)


def _repulsion_exact(cfg, pos, rows=None):
    """Exact all-pairs 1/d^2 repulsion, chunked over bodies.

    The reference uses a theta=0.75 Barnes-Hut tree because its CPU cannot
    afford O(n^2) (number_fluid2d.c:386-438); at 131k bodies the full
    pairwise sum is ~150 GFLOP of elementwise arithmetic, so this engine
    simply computes the true force (error 0, strictly tighter than any
    MAC).  The explicit
    difference formulation (not the |a|^2+|b|^2-2ab matmul identity) avoids
    catastrophic f32 cancellation for near pairs at 7e3-scale coordinates.

    `rows` (a subset of positions) restricts the force TARGETS while still
    summing over all of `pos` — the per-device slice of the multi-chip
    runner (parallel/nbody_sharded.py), which scales the O(n^2) compute by
    the device count.
    """
    targets = pos if rows is None else rows
    nt, dims = targets.shape
    CH = min(cfg.chunk, nt)
    n_pad = -(-nt // CH) * CH
    posp = jnp.pad(targets, ((0, n_pad - nt), (0, 0)))
    # per-component (CH, n) blocks keep the body axis on the 128-wide lane
    # dimension; a (CH, n, dims) layout would use dims=2 of 128 lanes
    comps = [pos[:, k] for k in range(dims)]

    def chunk_force(pc):
        d = [pc[:, k][:, None] - comps[k][None, :] for k in range(dims)]
        d2 = d[0] * d[0] + d[1] * d[1]
        if dims == 3:
            d2 = d2 + d[2] * d[2]
        d2 = d2 + cfg.softening
        inv = lax.rsqrt(d2)
        # self-pair: d = 0 contributes exactly zero force.
        # w = repulsion * d2^(-3/2) via inv^3 — no per-pair division
        w = cfg.repulsion * (inv * inv * inv)
        return jnp.stack([jnp.sum(w * dk, axis=1) for dk in d], -1)

    f = lax.map(chunk_force, posp.reshape(-1, CH, dims))
    return f.reshape(n_pad, dims)[:nt]


def _repulsion_grid(cfg, pos):
    """Grid-monopole repulsion: exact near field over 3^d neighbor cells +
    cell-COM monopole far field (array replacement of
    apply_repulsion_from_tree, number_fluid2d.c:386-438)."""
    n, dims = pos.shape
    G = cfg.grid_res

    lo = jnp.min(pos, axis=0)
    hi = jnp.max(pos, axis=0)
    span = jnp.maximum(jnp.max(hi - lo), 1e-3)
    cell = span / G
    ij = jnp.clip(((pos - lo) / cell).astype(jnp.int32), 0, G - 1)

    if dims == 2:
        cid = ij[:, 1] * G + ij[:, 0]
        M = G * G
    else:
        cid = (ij[:, 2] * G + ij[:, 1]) * G + ij[:, 0]
        M = G * G * G

    # cell monopoles
    mass = jnp.zeros(M, pos.dtype).at[cid].add(1.0)
    mpos = jnp.zeros((M, dims), pos.dtype).at[cid].add(pos)
    com = mpos / jnp.maximum(mass, 1.0)[:, None]

    # far field: monopole force from every cell, chunked over bodies so
    # the (chunk, M, dims) intermediate stays bounded (the unchunked
    # (n, M, dims) product is >1 GB at the reference's 131k bodies)
    CH = min(n, 4096)
    n_pad = -(-n // CH) * CH
    posp = jnp.pad(pos, ((0, n_pad - n), (0, 0)))

    def far_chunk(pc):
        d = pc[:, None, :] - com[None, :, :]          # (CH, M, dims)
        d2 = jnp.sum(d * d, axis=-1) + cfg.softening
        inv_d = 1.0 / jnp.sqrt(d2)
        fmag = cfg.repulsion * mass[None, :] / d2
        return jnp.sum((fmag * inv_d)[..., None] * d, axis=1)

    far = lax.map(far_chunk, posp.reshape(-1, CH, dims))
    far = far.reshape(n_pad, dims)[:n]

    # near field: subtract this body's own cell + neighbors' monopoles and
    # add the exact pairwise forces from those cells' bodies
    from ..ops import cell_list as cl_ops

    cap = max(16, int(8 * n / M) + 8)
    grid2 = cl_ops.CellGrid(Gx=G, Gy=G, cell=1.0, capacity=cap)

    if dims == 3 or n > cfg.near_field_max:
        # near field approximated with the monopole only (the far field
        # already includes every cell): BH accuracy at coarse theta.  The
        # exact 3x3-cell near field materializes (n, 9*capacity) pair
        # blocks — prohibitive at the reference's 131k bodies, where the
        # native engine (nbody_native) is the high-fidelity path.
        return far

    cl = cl_ops.CellList(
        table=jnp.full((M * cap,), n, jnp.int32)
        .at[cid * cap + _rank_in_cell(cid, n)]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")
        .reshape(M, cap),
        cid=cid,
        n=n,
    )

    near = jnp.zeros_like(pos)
    self_idx = jnp.arange(n, dtype=jnp.int32)
    for ox, oy in cl_ops.NEIGHBOR_OFFSETS:
        idx, valid = cl_ops.neighbor_indices(grid2, cl, ox, oy)
        j = jnp.clip(idx, 0, n - 1)
        dd = pos[:, None, :] - pos[j]
        dd2 = jnp.sum(dd * dd, axis=-1) + cfg.softening
        ok = valid & (idx != self_idx[:, None])
        inv = 1.0 / jnp.sqrt(dd2)
        fm = jnp.where(ok, cfg.repulsion / dd2, 0.0)
        near = near + jnp.sum((fm * inv)[..., None] * dd, axis=1)

        # subtract the monopole contribution of this neighbor cell (it was
        # counted in the far field)
        cx = cl.cid % G + ox
        cy = cl.cid // G + oy
        in_grid = (cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
        nc = jnp.where(in_grid, cy * G + cx, 0)
        dcm = pos - com[nc]
        dcm2 = jnp.sum(dcm * dcm, axis=-1) + cfg.softening
        invc = 1.0 / jnp.sqrt(dcm2)
        fmc = jnp.where(in_grid, cfg.repulsion * mass[nc] / dcm2, 0.0)
        near = near - (fmc * invc)[:, None] * dcm

    return far + near


def _rank_in_cell(cid, n):
    order = jnp.argsort(cid)
    sorted_cid = cid[order]
    first = jnp.searchsorted(sorted_cid, sorted_cid, side="left")
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    rank = jnp.zeros(n, jnp.int32).at[order].set(rank_sorted)
    return rank


def step(cfg: GraphLayoutConfig, s: GraphLayoutState) -> GraphLayoutState:
    pos = s.pos.at[0].set(0.0)  # root pinned (worker_step :469-476)
    vel = s.vel.at[0].set(0.0)

    rep = (_repulsion_exact(cfg, pos) if cfg.engine == "exact"
           else _repulsion_grid(cfg, pos))
    f = _spring_forces_static(cfg, pos) + rep

    v = (vel + f * cfg.dt) * cfg.damping
    speed2 = jnp.sum(v * v, axis=-1, keepdims=True)
    scale = jnp.where(
        speed2 > cfg.max_speed**2,
        cfg.max_speed / jnp.sqrt(jnp.maximum(speed2, 1e-30)),
        1.0,
    )
    v = v * scale
    v = v.at[0].set(0.0)
    new_pos = pos + v * cfg.dt
    new_pos = new_pos.at[0].set(0.0)
    return GraphLayoutState(pos=new_pos, vel=v, edges=s.edges,
                            steps=s.steps + 1)


def run(cfg: GraphLayoutConfig, s: GraphLayoutState, n_steps: int):
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
