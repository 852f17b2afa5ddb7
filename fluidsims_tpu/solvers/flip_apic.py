"""2-D hybrid FLIP/APIC incompressible fluid on a collocated grid.

Behavioral spec: tau_flip_apic.cu — jittered block seed with initial swirl
(k_seed :72-93); linear-hat P2G with blendable APIC affine term (k_p2g
:105-131); grid normalize + gravity + edge clamps (k_normalize_forces
:133-150); central divergence, 48 Jacobi pressure iterations, gradient
projection (k_divergence/k_jacobi/k_project :152-184); bilinear G2P with
FLIP/PIC blend, affine matrix from central differences of the projected
field, advection with restitution -0.35 walls at [0.01, 0.99], and density
rasterization (sample_grid/k_g2p :186-241).

Design: engine="dense" bins particles into the cell-dense (n, n, K) layout
(ops/cell_dense.py) once per step: P2G becomes 9 per-offset dense
sums-over-K followed by static grid shifts (with an exact per-axis
multiplicity factor reproducing the reference's index clipping at the
walls), and G2P sampling becomes per-slot hat weights times grid values
broadcast over K (static shifts of the grid — zero gathers).  Particles
beyond the K=bin_capacity occupancy of a cell are dropped from the
transfers (the default K is sized ~16x the mean occupancy; overflow is
countable via ops.cell_dense).  The Jacobi loop is lax.fori_loop; the
whole step is one jit region.  engine="scatter" is the reference's own
formulation — atomic-add P2G (`.at[].add`) and a
per-particle gather G2P — exact at any occupancy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import BaseConfig

__all__ = ["FlipApicConfig", "FlipApicState", "init", "step", "run",
           "density_grid"]


@dataclass(frozen=True)
class FlipApicConfig(BaseConfig):
    particles: int = 1 << 16
    grid: int = 128
    jacobi: int = 48
    dt: float = 0.004
    gravity: float = 7.5
    flip: float = 0.97
    apic: float = 0.85
    jitter: float = 0.22
    seed: int = 1337
    # dense = cell-dense transfers, which drop particles beyond
    # bin_capacity per cell; scatter = the reference's atomic-add P2G,
    # exact at any occupancy.  On the H100 neither was reliably faster
    # (PERF.md, engine A/B), so the default stayed dense.
    engine: str = "dense"
    bin_capacity: int = 0   # 0 = auto (~16x mean occupancy)
    dtype: str = "float32"

    def validate(self):
        self._require(self.particles > 0, "particles must be positive")
        self._require(self.grid >= 16, "grid must be >= 16")
        self._require(0.0 <= self.flip <= 1.0, "flip in [0,1]")
        self._require(0.0 <= self.apic <= 1.0, "apic in [0,1]")
        self._require(self.engine in ("dense", "scatter"),
                      "engine must be dense or scatter")

    @property
    def capacity(self) -> int:
        if self.bin_capacity > 0:
            return self.bin_capacity
        mean = self.particles / ((self.grid - 1) ** 2)
        return max(32, int(np.ceil(16.0 * mean / 8.0)) * 8)


class FlipApicState(NamedTuple):
    pos: jnp.ndarray       # (np, 2) in [0,1]^2
    vel: jnp.ndarray       # (np, 2)
    affine_x: jnp.ndarray  # (np, 2) APIC d(vel)/dx
    affine_y: jnp.ndarray  # (np, 2) APIC d(vel)/dy
    density: jnp.ndarray   # (n, n) int32 particle counts (render state)


def init(cfg: FlipApicConfig) -> FlipApicState:
    """Jittered block with a swirl velocity field (k_seed, :72-93), using the
    reference's integer hash for the jitter."""
    n_p = cfg.particles
    side = int(np.ceil(np.sqrt(n_p)))
    idx = np.arange(n_p, dtype=np.uint64)
    ix = idx % side
    iy = idx // side
    h = (idx * np.uint64(747796405) + np.uint64(cfg.seed * 2891336453)) \
        & np.uint64(0xFFFFFFFF)
    h = ((h ^ (h >> np.uint64(16))) * np.uint64(2246822519)) \
        & np.uint64(0xFFFFFFFF)
    rx = ((h & np.uint64(1023)).astype(np.float64) / 1023.0 - 0.5) * cfg.jitter
    ry = (((h >> np.uint64(10)) & np.uint64(1023)).astype(np.float64) / 1023.0
          - 0.5) * cfg.jitter
    x = 0.12 + 0.45 * ((ix + 0.5 + rx) / side)
    y = 0.12 + 0.74 * ((iy + 0.5 + ry) / side)
    x = np.clip(x, 0.02, 0.98)
    y = np.clip(y, 0.02, 0.98)
    cx, cy = x - 0.38, y - 0.55
    vel = np.stack([-1.8 * cy, 1.8 * cx], -1)

    dt = cfg.jax_dtype
    return FlipApicState(
        pos=jnp.asarray(np.stack([x, y], -1), dt),
        vel=jnp.asarray(vel, dt),
        affine_x=jnp.zeros((n_p, 2), dt),
        affine_y=jnp.zeros((n_p, 2), dt),
        density=jnp.zeros((cfg.grid, cfg.grid), jnp.int32),
    )


def _w1(x):
    """Linear hat weight (w1, :67-70)."""
    ax = jnp.abs(x)
    return jnp.where(ax < 1.0, 1.0 - ax, 0.0)


def _p2g(cfg, pos, vel, ax, ay, apic=None):
    """Particle-to-grid mass/momentum transfer (k_p2g, :105-131): the CUDA
    atomicAdd becomes 9 masked scatter-adds."""
    n = cfg.grid
    apic = cfg.apic if apic is None else apic
    gx = pos[:, 0] * (n - 1)
    gy = pos[:, 1] * (n - 1)
    base_x = jnp.floor(gx).astype(jnp.int32)
    base_y = jnp.floor(gy).astype(jnp.int32)

    mass = jnp.zeros(n * n, pos.dtype)
    mom_u = jnp.zeros(n * n, pos.dtype)
    mom_v = jnp.zeros(n * n, pos.dtype)

    for oy in (-1, 0, 1):
        j = jnp.clip(base_y + oy, 0, n - 1)
        wy = _w1(gy - j)
        for ox in (-1, 0, 1):
            i = jnp.clip(base_x + ox, 0, n - 1)
            wx = _w1(gx - i)
            wt = wx * wy
            rx = (i - gx) / (n - 1)
            ry = (j - gy) / (n - 1)
            vvx = vel[:, 0] + apic * (ax[:, 0] * rx + ay[:, 0] * ry)
            vvy = vel[:, 1] + apic * (ax[:, 1] * rx + ay[:, 1] * ry)
            flat = j * n + i
            ok = wt > 0.0
            flat = jnp.where(ok, flat, n * n)
            mass = mass.at[flat].add(jnp.where(ok, wt, 0.0), mode="drop")
            mom_u = mom_u.at[flat].add(jnp.where(ok, wt * vvx, 0.0),
                                       mode="drop")
            mom_v = mom_v.at[flat].add(jnp.where(ok, wt * vvy, 0.0),
                                       mode="drop")
    return (mass.reshape(n, n), mom_u.reshape(n, n), mom_v.reshape(n, n))


def _sample(u, v, px, py, n):
    """Bilinear velocity sample (sample_grid, :186-200). Arrays are (n, n)
    with [j, i] = [y, x]."""
    gx = jnp.clip(px * (n - 1), 0.0, n - 1.001)
    gy = jnp.clip(py * (n - 1), 0.0, n - 1.001)
    i0 = jnp.floor(gx).astype(jnp.int32)
    j0 = jnp.floor(gy).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, n - 1)
    j1 = jnp.minimum(j0 + 1, n - 1)
    tx = gx - i0
    ty = gy - j0

    from ..ops.gather import gather2d

    def bil(f):
        f00 = gather2d(f, j0, i0)
        f10 = gather2d(f, j0, i1)
        f01 = gather2d(f, j1, i0)
        f11 = gather2d(f, j1, i1)
        return (1 - tx) * ((1 - ty) * f00 + ty * f01) \
            + tx * ((1 - ty) * f10 + ty * f11)

    return bil(u), bil(v)


def _grid_phase(cfg, mass, u, v):
    """normalize + gravity + clamps -> divergence -> Jacobi -> projection
    (k_normalize_forces..k_project, :133-184).  Shared by both engines.
    Returns (u_prev, v_prev, u_proj, v_proj)."""
    n = cfg.grid
    dt = cfg.dt

    has_mass = mass > 1e-8
    u = jnp.where(has_mass, u / jnp.maximum(mass, 1e-8), u)
    v = jnp.where(has_mass, v / jnp.maximum(mass, 1e-8) - cfg.gravity * dt, v)
    col = jnp.arange(n)
    edge_x = (col == 0) | (col == n - 1)
    u = jnp.where(edge_x[None, :], 0.0, u)
    v = jnp.where(edge_x[:, None], 0.0, v)
    u_prev, v_prev = u, v

    # divergence on the interior (k_divergence, :152-161)
    div = jnp.zeros_like(u)
    div = div.at[1:-1, 1:-1].set(
        -0.5 * (n - 1) * (
            u[1:-1, 2:] - u[1:-1, :-2] + v[2:, 1:-1] - v[:-2, 1:-1]
        )
    )

    # Jacobi pressure (k_jacobi, :162-172); boundary ring stays 0
    def jac(_, p):
        interior = 0.25 * (
            div[1:-1, 1:-1]
            + p[1:-1, :-2] + p[1:-1, 2:] + p[:-2, 1:-1] + p[2:, 1:-1]
        )
        return jnp.zeros_like(p).at[1:-1, 1:-1].set(interior)

    p = lax.fori_loop(0, cfg.jacobi, jac, jnp.zeros_like(u))

    # projection on the interior (k_project, :173-184); u_proj starts at 0
    # (cleared each step) and only the interior is written — matching the
    # reference's k_clear_grid + interior-only k_project.
    u_proj = jnp.zeros_like(u).at[1:-1, 1:-1].set(
        u[1:-1, 1:-1] - 0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) / (n - 1)
    )
    v_proj = jnp.zeros_like(v).at[1:-1, 1:-1].set(
        v[1:-1, 1:-1] - 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) / (n - 1)
    )
    return u_prev, v_prev, u_proj, v_proj


def _step_scatter(cfg: FlipApicConfig, s: FlipApicState,
                  grid_reduce=None, flip=None, apic=None) -> FlipApicState:
    n = cfg.grid
    dt = cfg.dt
    flip = cfg.flip if flip is None else flip

    mass, u, v = _p2g(cfg, s.pos, s.vel, s.affine_x, s.affine_y, apic=apic)
    if grid_reduce is not None:
        mass, u, v = grid_reduce((mass, u, v))
    u_prev, v_prev, u_proj, v_proj = _grid_phase(cfg, mass, u, v)

    # G2P (k_g2p, :202-241)
    px, py = s.pos[:, 0], s.pos[:, 1]
    new_u, new_v = _sample(u_proj, v_proj, px, py, n)
    old_u, old_v = _sample(u_prev, v_prev, px, py, n)
    flip_u = s.vel[:, 0] + new_u - old_u
    flip_v = s.vel[:, 1] + new_v - old_v
    vel_x = (1 - flip) * new_u + flip * flip_u
    vel_y = (1 - flip) * new_v + flip * flip_v

    h = 1.0 / (n - 1)
    ux1, vx1 = _sample(u_proj, v_proj, px + h, py, n)
    ux0, vx0 = _sample(u_proj, v_proj, px - h, py, n)
    uy1, vy1 = _sample(u_proj, v_proj, px, py + h, n)
    uy0, vy0 = _sample(u_proj, v_proj, px, py - h, n)
    affine_x = jnp.stack([0.5 * (ux1 - ux0) / h, 0.5 * (vx1 - vx0) / h], -1)
    affine_y = jnp.stack([0.5 * (uy1 - uy0) / h, 0.5 * (vy1 - vy0) / h], -1)

    nx = px + vel_x * dt
    ny_ = py + vel_y * dt
    hit_x = (nx < 0.01) | (nx > 0.99)
    hit_y = (ny_ < 0.01) | (ny_ > 0.99)
    vel_x = jnp.where(hit_x, vel_x * -0.35, vel_x)
    vel_y = jnp.where(hit_y, vel_y * -0.35, vel_y)
    nx = jnp.clip(nx, 0.01, 0.99)
    ny_ = jnp.clip(ny_, 0.01, 0.99)

    rx = jnp.clip((nx * n).astype(jnp.int32), 0, n - 1)
    ry = jnp.clip((ny_ * n).astype(jnp.int32), 0, n - 1)
    density = jnp.zeros(n * n, jnp.int32).at[ry * n + rx].add(1).reshape(n, n)
    if grid_reduce is not None:
        density = grid_reduce(density)

    return FlipApicState(
        pos=jnp.stack([nx, ny_], -1),
        vel=jnp.stack([vel_x, vel_y], -1),
        affine_x=affine_x,
        affine_y=affine_y,
        density=density,
    )


def _gshift(a, oy: int, ox: int):
    """(n, n) grid view at offset: out[j, i] = a[j + oy, i + ox], zeros
    outside the grid."""
    n0, n1 = a.shape
    padded = jnp.pad(a, ((max(-oy, 0), max(oy, 0)),
                         (max(-ox, 0), max(ox, 0))))
    y0 = max(-oy, 0) + oy
    x0 = max(-ox, 0) + ox
    return padded[y0:y0 + n0, x0:x0 + n1]


def _dense_transfers(cfg, dgx, dgy, dvx, dvy, dax, day, dpx, dpy,
                     cxp, cxm, cyp, cym, occf, grid_reduce=None,
                     flip=None, apic=None):
    """P2G -> grid phase -> G2P -> advection on the cell-dense (n, n, K)
    layout, shared by the scatter-built engine (_step_dense) and the
    resident-slab engine (solvers/flip_resident.py).  All inputs are
    per-slot (n, n, K) channels (dax/day are (n, n, K, 2)); empty slots
    must hold zeros with occf = 0.  Returns dense_out (n, n, K, 8) =
    [new px, py, vx, vy, ax0, ax1, ay0, ay1]."""
    n = cfg.grid
    dt = cfg.dt
    dtype = dgx.dtype
    K = dgx.shape[-1]
    h = 1.0 / (n - 1)
    flip = cfg.flip if flip is None else flip
    apic = cfg.apic if apic is None else apic

    ix = lax.broadcasted_iota(jnp.int32, (n, n, K), 1).astype(dtype)
    iy = lax.broadcasted_iota(jnp.int32, (n, n, K), 0).astype(dtype)
    # per-axis clip multiplicity: at the walls the reference's index clip
    # folds the out-of-grid offset onto the wall cell, doubling its weight
    mx0 = 1.0 + (ix == 0) + (ix == n - 1)
    my0 = 1.0 + (iy == 0) + (iy == n - 1)

    # ---- P2G (k_p2g semantics; 9 dense sums + shifts) ----
    mass = jnp.zeros((n, n), dtype)
    mom_u = jnp.zeros((n, n), dtype)
    mom_v = jnp.zeros((n, n), dtype)
    for oy in (-1, 0, 1):
        jt = iy + oy
        wy = _w1(dgy - jt) * (my0 if oy == 0 else 1.0)
        ry = (jt - dgy) / (n - 1)
        for ox in (-1, 0, 1):
            it = ix + ox
            wt = _w1(dgx - it) * (mx0 if ox == 0 else 1.0) * wy * occf
            rx = (it - dgx) / (n - 1)
            vvx = dvx + apic * (dax[..., 0] * rx + day[..., 0] * ry)
            vvy = dvy + apic * (dax[..., 1] * rx + day[..., 1] * ry)
            mass = mass + _gshift(jnp.sum(wt, -1), -oy, -ox)
            mom_u = mom_u + _gshift(jnp.sum(wt * vvx, -1), -oy, -ox)
            mom_v = mom_v + _gshift(jnp.sum(wt * vvy, -1), -oy, -ox)

    if grid_reduce is not None:
        mass, mom_u, mom_v = grid_reduce((mass, mom_u, mom_v))
    u_prev, v_prev, u_proj, v_proj = _grid_phase(cfg, mass, mom_u, mom_v)

    # ---- G2P (sample_grid/k_g2p semantics; hat-window broadcasts) ----
    def sample(gu, gv, sx, sy, wxs, wys):
        """Per-slot bilinear sample of grids at clipped per-slot coords:
        the hat weight selects exactly the two active corners per axis
        inside the static offset window."""
        su = jnp.zeros((n, n, K), dtype)
        sv = jnp.zeros((n, n, K), dtype)
        for oy in wys:
            wy = _w1(sy - (iy + oy))
            for ox in wxs:
                w = _w1(sx - (ix + ox)) * wy
                su = su + w * _gshift(gu, oy, ox)[:, :, None]
                sv = sv + w * _gshift(gv, oy, ox)[:, :, None]
        return su, sv

    clipc = lambda a: jnp.clip(a, 0.0, n - 1.001)  # noqa: E731
    # per-particle sample coordinates, computed exactly as the scatter
    # path does (then scattered), so FP matches it bit for bit
    cgx, cgy = clipc(dgx), clipc(dgy)
    cxp = clipc(cxp)
    cxm = clipc(cxm)
    cyp = clipc(cyp)
    cym = clipc(cym)

    C = (0, 1)          # central window per axis
    W = (-2, -1, 0, 1, 2)  # wide window for the +-h samples (covers clips)
    new_u, new_v = sample(u_proj, v_proj, cgx, cgy, C, C)
    old_u, old_v = sample(u_prev, v_prev, cgx, cgy, C, C)
    flip_u = dvx + new_u - old_u
    flip_v = dvy + new_v - old_v
    vel_x = (1 - flip) * new_u + flip * flip_u
    vel_y = (1 - flip) * new_v + flip * flip_v

    ux1, vx1 = sample(u_proj, v_proj, cxp, cgy, W, C)
    ux0, vx0 = sample(u_proj, v_proj, cxm, cgy, W, C)
    uy1, vy1 = sample(u_proj, v_proj, cgx, cyp, C, W)
    uy0, vy0 = sample(u_proj, v_proj, cgx, cym, C, W)
    nax_x = 0.5 * (ux1 - ux0) / h
    nax_y = 0.5 * (vx1 - vx0) / h
    nay_x = 0.5 * (uy1 - uy0) / h
    nay_y = 0.5 * (vy1 - vy0) / h

    # advect + restitution walls, per slot
    nx_ = dpx + vel_x * dt
    ny_ = dpy + vel_y * dt
    hit_x = (nx_ < 0.01) | (nx_ > 0.99)
    hit_y = (ny_ < 0.01) | (ny_ > 0.99)
    vel_x = jnp.where(hit_x, vel_x * -0.35, vel_x)
    vel_y = jnp.where(hit_y, vel_y * -0.35, vel_y)
    nx_ = jnp.clip(nx_, 0.01, 0.99)
    ny_ = jnp.clip(ny_, 0.01, 0.99)

    return jnp.stack(
        [nx_, ny_, vel_x, vel_y, nax_x, nax_y, nay_x, nay_y], -1)


def _step_dense(cfg: FlipApicConfig, s: FlipApicState,
                grid_reduce=None, flip=None, apic=None) -> FlipApicState:
    """Cell-dense engine: bin once, transfers via dense sums + static
    shifts (module docstring).  `grid_reduce` (e.g. lax.psum over a mesh
    axis) merges per-device partial P2G transfers and density rasters —
    the multi-chip hook used by parallel/flip_sharded.py."""
    from ..ops import cell_dense as cd

    n = cfg.grid
    dtype = s.pos.dtype
    K = cfg.capacity
    px, py = s.pos[:, 0], s.pos[:, 1]
    gxp = px * (n - 1)
    gyp = py * (n - 1)
    bxp = jnp.clip(jnp.floor(gxp).astype(jnp.int32), 0, n - 1)
    byp = jnp.clip(jnp.floor(gyp).astype(jnp.int32), 0, n - 1)
    grid = cd.DenseGrid(Gx=n, Gy=n, cell=1.0, K=K)
    cells = cd.bin_particles(grid, s.pos, cid=byp * n + bxp)

    # ONE stacked scatter for all per-particle inputs (element scatters
    # are the pathology; row scatters amortize it across channels).  The
    # direct value-scatter variant that won 25% for MPM measured ~4%
    # SLOWER here (K=24 keeps the inverse-map gather small), so FLIP
    # keeps the inverse-map transfer.
    h = 1.0 / (n - 1)
    packed = jnp.stack([
        gxp, gyp, s.vel[:, 0], s.vel[:, 1],
        s.affine_x[:, 0], s.affine_x[:, 1],
        s.affine_y[:, 0], s.affine_y[:, 1],
        px, py,
        (px + h) * (n - 1), (px - h) * (n - 1),
        (py + h) * (n - 1), (py - h) * (n - 1),
    ], -1)
    dall = cd.scatter_field(grid, cells, packed)      # (n, n, K, 14)
    occf = cells.occ.astype(dtype)

    dense_out = _dense_transfers(
        cfg, dall[..., 0], dall[..., 1], dall[..., 2], dall[..., 3],
        dall[..., 4:6], dall[..., 6:8], dall[..., 8], dall[..., 9],
        dall[..., 10], dall[..., 11], dall[..., 12], dall[..., 13],
        occf, grid_reduce, flip=flip, apic=apic)

    # back to particle order with ONE stacked gather (dropped/overflow
    # particles keep their previous state)
    got = cd.gather_result(grid, cells, dense_out)    # (np, 8)
    okc = cells.ok[:, None]
    old = jnp.concatenate(
        [s.pos, s.vel, s.affine_x, s.affine_y], -1)
    out = jnp.where(okc, got, old)
    out_px, out_py = out[:, 0], out[:, 1]
    out_vx, out_vy = out[:, 2], out[:, 3]
    out_ax = out[:, 4:6]
    out_ay = out[:, 6:8]

    rx_ = jnp.clip((out_px * n).astype(jnp.int32), 0, n - 1)
    ry_ = jnp.clip((out_py * n).astype(jnp.int32), 0, n - 1)
    density = jnp.zeros(n * n, jnp.int32).at[ry_ * n + rx_].add(1)
    if grid_reduce is not None:
        density = grid_reduce(density)

    return FlipApicState(
        pos=jnp.stack([out_px, out_py], -1),
        vel=jnp.stack([out_vx, out_vy], -1),
        affine_x=out_ax,
        affine_y=out_ay,
        density=density.reshape(n, n),
    )


def step(cfg: FlipApicConfig, s: FlipApicState,
         grid_reduce=None, flip=None, apic=None) -> FlipApicState:
    """`flip`/`apic` optionally override the config blend factors as traced
    scalars so the interactive F/A nudges run without a recompile (the
    reference's instant keys, tau_flip_apic.cu)."""
    if cfg.engine == "dense":
        return _step_dense(cfg, s, grid_reduce, flip=flip, apic=apic)
    return _step_scatter(cfg, s, grid_reduce, flip=flip, apic=apic)


def density_grid(s: FlipApicState):
    return s.density


def overflow_count(cfg: FlipApicConfig, s: FlipApicState):
    """Particles beyond their cell's K capacity under the dense engine's
    binning (zero under engine='scatter', which is exact).  Reported by the
    CLI so clustered splashes can't silently lose physics."""
    import jax.numpy as jnp

    from ..ops import cell_dense as cd

    if cfg.engine != "dense":
        return jnp.zeros((), jnp.int32)
    n = cfg.grid
    bxp = jnp.clip(jnp.floor(s.pos[:, 0] * (n - 1)).astype(jnp.int32), 0, n - 1)
    byp = jnp.clip(jnp.floor(s.pos[:, 1] * (n - 1)).astype(jnp.int32), 0, n - 1)
    grid = cd.DenseGrid(Gx=n, Gy=n, cell=1.0, K=cfg.capacity)
    return cd.bin_particles(grid, s.pos, cid=byp * n + bxp).overflow


def run(cfg: FlipApicConfig, s: FlipApicState, n_steps: int,
        flip=None, apic=None) -> FlipApicState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st, flip=flip, apic=apic),
                      s, n_steps)
