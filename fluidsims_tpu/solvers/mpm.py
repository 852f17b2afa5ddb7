"""2-D MLS-MPM elastoplastic solver with three materials (mud/snow/sand).

Behavioral spec: tau_mpm.cu — quadratic B-spline weights (:138-147);
neo-Hookean-style stress P F^T = mu(Fe Fe^T - I) + lambda log(J) J I with
plastic hardening exp(h(1-Jp)) and per-material tweaks (k_p2g :123-183:
snow clamps the diagonal of Fe and decays shear, mud weakens shear 0.25x,
sand hardens shear 1.8x / softens lambda 0.75x); grid momentum normalize +
gravity + 3-cell sticky boundary bands (k_grid_update :185-198); G2P affine
C reconstruction, F update F <- (I + dt C) F, Jp volume-ratio tracking
clamped to [0.05, 20], position clamp to [2dx, (G-3)dx] (k_g2p :200-257);
jittered block init with shear velocity profile (reset_particles :304-320);
dx = boxX/(Gx-1) (step_mpm :327).

Design: engine="scatter" (the default) is the reference's formulation — P2G's 9-target
atomicAdd becomes 9 masked scatter-adds and G2P is a pure gather;
engine="dense" bins particles into the cell-dense layout
(ops/cell_dense.py) and does both transfers as dense sums and static
shifts.  The 2x2 matrix products run at HIGHEST precision, so a float32
einsum is never lowered to a reduced-precision (TF32) matrix unit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import BaseConfig

__all__ = ["MPMConfig", "MPMState", "MATERIALS", "init", "step", "run"]

MATERIALS = {"mud": 0, "snow": 1, "sand": 2}
_HIGHEST = lax.Precision.HIGHEST


@dataclass(frozen=True)
class MPMConfig(BaseConfig):
    n: int = 1 << 15
    gx: int = 96
    gy: int = 96
    box_x: float = 1.0
    box_y: float = 1.0
    dt: float = 8.0e-5
    gravity: float = 9.81
    particle_mass: float = 1.0
    volume: float = 1.0
    hardening: float = 10.0
    mu0: float = 18.0
    lambda0: float = 40.0
    critical_compression: float = 2.5e-2
    critical_stretch: float = 7.5e-3
    material: str = "snow"
    seed: int = 2026
    # scatter = the reference's atomic-add P2G, exact at any occupancy and
    # on the H100 the faster engine (PERF.md, engine A/B); dense = cell-dense
    # transfers, which drop particles beyond bin_capacity per cell
    engine: str = "scatter"
    bin_capacity: int = 0   # 0 = auto (~16x mean occupancy)
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.gx >= 8 and self.gy >= 8, "grid too small")
        self._require(self.material in MATERIALS, f"material {self.material}")
        self._require(self.engine in ("dense", "scatter"),
                      "engine must be dense or scatter")

    @property
    def capacity(self) -> int:
        if self.bin_capacity > 0:
            return self.bin_capacity
        mean = self.n / (self.gx * self.gy)
        return max(32, int(np.ceil(16.0 * mean / 8.0)) * 8)

    @property
    def dx(self):
        return self.box_x / (self.gx - 1)


class MPMState(NamedTuple):
    pos: jnp.ndarray  # (n, 2)
    vel: jnp.ndarray  # (n, 2)
    F: jnp.ndarray    # (n, 2, 2) elastic deformation gradient
    Jp: jnp.ndarray   # (n,) plastic volume ratio


def init(cfg: MPMConfig) -> MPMState:
    """Jittered block at [0.22,0.64]x[0.28,0.73] with shear velocity
    (reset_particles, tau_mpm.cu:304-320)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    nx = int(np.sqrt(n))
    ny = (n + nx - 1) // nx
    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    x = 0.22 + 0.42 * (ix + 0.5) / nx
    y = 0.28 + 0.45 * (iy + 0.5) / ny
    x = x + (rng.random(n) - 0.5) * 0.12 / nx
    y = y + (rng.random(n) - 0.5) * 0.12 / ny
    vel = np.stack([1.0 * (0.5 - y), np.zeros(n)], -1)

    dt = cfg.jax_dtype
    F = jnp.broadcast_to(jnp.eye(2, dtype=dt), (n, 2, 2))
    return MPMState(
        pos=jnp.asarray(np.stack([x, y], -1), dt),
        vel=jnp.asarray(vel, dt),
        F=F,
        Jp=jnp.ones(n, dt),
    )


def _bspline_w(f):
    """Quadratic B-spline weights for offsets 0,1,2 given fractional f
    (tau_mpm.cu:138-147)."""
    return (
        0.5 * (1.5 - f) ** 2,
        0.75 - (f - 1.0) ** 2,
        0.5 * (f - 0.5) ** 2,
    )


def _det2(F):
    return F[:, 0, 0] * F[:, 1, 1] - F[:, 0, 1] * F[:, 1, 0]


def _step_scatter(cfg: MPMConfig, s: MPMState,
                  grid_reduce=None) -> MPMState:
    n_p = cfg.n
    Gx, Gy = cfg.gx, cfg.gy
    dx = cfg.dx
    inv_dx = 1.0 / dx
    dt = cfg.dt
    mat = MATERIALS[cfg.material]

    Xp = s.pos * inv_dx
    base = jnp.floor(Xp - 0.5).astype(jnp.int32)
    frac = Xp - base
    wx = _bspline_w(frac[:, 0])
    wy = _bspline_w(frac[:, 1])

    # --- stress from the (possibly plastically-clamped) elastic F ---
    Fe = s.F
    if mat == 1:  # snow: clamp principal-ish entries, decay shear
        Fe = Fe.at[:, 0, 0].set(
            jnp.clip(Fe[:, 0, 0], 1.0 - cfg.critical_compression,
                     1.0 + cfg.critical_stretch)
        )
        Fe = Fe.at[:, 1, 1].set(
            jnp.clip(Fe[:, 1, 1], 1.0 - cfg.critical_compression,
                     1.0 + cfg.critical_stretch)
        )
        Fe = Fe.at[:, 0, 1].multiply(0.98)
        Fe = Fe.at[:, 1, 0].multiply(0.98)
    J = jnp.maximum(_det2(Fe), 0.2)
    e = jnp.exp(cfg.hardening * (1.0 - s.Jp))
    mu = cfg.mu0 * e
    lam = cfg.lambda0 * e
    if mat == 0:
        mu = mu * 0.25
    elif mat == 2:
        mu = mu * 1.8
        lam = lam * 0.75

    FFt = jnp.einsum("nij,nkj->nik", Fe, Fe, precision=_HIGHEST)
    I = jnp.eye(2, dtype=Fe.dtype)
    PFt = mu[:, None, None] * (FFt - I) \
        + (lam * jnp.log(J) * J)[:, None, None] * I
    stress = PFt * (-4.0 * inv_dx * inv_dx * dt * cfg.volume)

    # --- P2G: 9 masked scatter-adds (k_p2g, :167-182) ---
    mass = jnp.zeros(Gx * Gy, Fe.dtype)
    mom_x = jnp.zeros(Gx * Gy, Fe.dtype)
    mom_y = jnp.zeros(Gx * Gy, Fe.dtype)
    m_v = cfg.particle_mass * s.vel

    for ox in range(3):
        for oy in range(3):
            ix = base[:, 0] + ox
            iy = base[:, 1] + oy
            ok = (ix >= 0) & (ix < Gx) & (iy >= 0) & (iy < Gy)
            w = wx[ox] * wy[oy]
            dposx = (ox - frac[:, 0]) * dx
            dposy = (oy - frac[:, 1]) * dx
            fx = stress[:, 0, 0] * dposx + stress[:, 0, 1] * dposy
            fy = stress[:, 1, 0] * dposx + stress[:, 1, 1] * dposy
            flat = jnp.where(ok, iy * Gx + ix, Gx * Gy)
            zero = jnp.zeros_like(w)
            mass = mass.at[flat].add(
                jnp.where(ok, w * cfg.particle_mass, zero), mode="drop")
            mom_x = mom_x.at[flat].add(
                jnp.where(ok, w * (m_v[:, 0] + fx), zero), mode="drop")
            mom_y = mom_y.at[flat].add(
                jnp.where(ok, w * (m_v[:, 1] + fy), zero), mode="drop")

    # --- grid update (k_grid_update, :185-198) ---
    mass2 = mass.reshape(Gy, Gx)
    gu = mom_x.reshape(Gy, Gx)
    gv = mom_y.reshape(Gy, Gx)
    if grid_reduce is not None:
        mass2, gu, gv = grid_reduce((mass2, gu, gv))
    has = mass2 > 0.0
    gu = jnp.where(has, gu / jnp.maximum(mass2, 1e-30), gu)
    gv = jnp.where(has, gv / jnp.maximum(mass2, 1e-30) - cfg.gravity * dt, gv)
    xsi = jnp.arange(Gx)[None, :]
    ysi = jnp.arange(Gy)[:, None]
    gu = jnp.where(has & (((xsi < 3) & (gu < 0)) | ((xsi > Gx - 4) & (gu > 0))),
                   0.0, gu)
    gv = jnp.where(has & (((ysi < 3) & (gv < 0)) | ((ysi > Gy - 4) & (gv > 0))),
                   0.0, gv)
    gu = jnp.where(has, gu, 0.0)
    gv = jnp.where(has, gv, 0.0)

    # --- G2P (k_g2p, :200-257) ---
    new_v = jnp.zeros((n_p, 2), Fe.dtype)
    C = jnp.zeros((n_p, 2, 2), Fe.dtype)
    for ox in range(3):
        for oy in range(3):
            ix = base[:, 0] + ox
            iy = base[:, 1] + oy
            ok = (ix >= 0) & (ix < Gx) & (iy >= 0) & (iy < Gy)
            w = jnp.where(ok, wx[ox] * wy[oy], 0.0)
            gvx = gu[jnp.clip(iy, 0, Gy - 1), jnp.clip(ix, 0, Gx - 1)]
            gvy = gv[jnp.clip(iy, 0, Gy - 1), jnp.clip(ix, 0, Gx - 1)]
            gvx = jnp.where(ok, gvx, 0.0)
            gvy = jnp.where(ok, gvy, 0.0)
            dposx = (ox - frac[:, 0]) * dx
            dposy = (oy - frac[:, 1]) * dx
            new_v = new_v + jnp.stack([w * gvx, w * gvy], -1)
            C = C + 4.0 * inv_dx * jnp.stack(
                [
                    jnp.stack([w * gvx * dposx, w * gvx * dposy], -1),
                    jnp.stack([w * gvy * dposx, w * gvy * dposy], -1),
                ],
                axis=1,
            )

    oldF = Fe
    newF = jnp.einsum("nij,njk->nik", I[None, :, :] + dt * C, oldF,
                      precision=_HIGHEST)
    oldJ = jnp.maximum(_det2(oldF), 1.0e-6)
    newJ = jnp.maximum(_det2(newF), 1.0e-6)
    if mat == 0:  # mud relaxes shear
        newF = newF.at[:, 0, 1].multiply(0.96)
        newF = newF.at[:, 1, 0].multiply(0.96)
    Jp = jnp.clip(s.Jp * oldJ / newJ, 0.05, 20.0)

    x = s.pos + dt * new_v
    x = jnp.stack(
        [
            jnp.clip(x[:, 0], 2.0 * dx, (Gx - 3.0) * dx),
            jnp.clip(x[:, 1], 2.0 * dx, (Gy - 3.0) * dx),
        ],
        -1,
    )

    return MPMState(pos=x, vel=new_v, F=newF, Jp=Jp)


def _plastic_and_stress(cfg, s):
    """Per-particle plasticity clamp + stress (k_p2g :146-165) — pure
    particle-space math shared by both engines."""
    mat = MATERIALS[cfg.material]
    inv_dx = 1.0 / cfg.dx
    Fe = s.F
    if mat == 1:  # snow: clamp principal-ish entries, decay shear
        Fe = Fe.at[:, 0, 0].set(
            jnp.clip(Fe[:, 0, 0], 1.0 - cfg.critical_compression,
                     1.0 + cfg.critical_stretch)
        )
        Fe = Fe.at[:, 1, 1].set(
            jnp.clip(Fe[:, 1, 1], 1.0 - cfg.critical_compression,
                     1.0 + cfg.critical_stretch)
        )
        Fe = Fe.at[:, 0, 1].multiply(0.98)
        Fe = Fe.at[:, 1, 0].multiply(0.98)
    J = jnp.maximum(_det2(Fe), 0.2)
    e = jnp.exp(cfg.hardening * (1.0 - s.Jp))
    mu = cfg.mu0 * e
    lam = cfg.lambda0 * e
    if mat == 0:
        mu = mu * 0.25
    elif mat == 2:
        mu = mu * 1.8
        lam = lam * 0.75
    FFt = jnp.einsum("nij,nkj->nik", Fe, Fe, precision=_HIGHEST)
    I = jnp.eye(2, dtype=Fe.dtype)
    PFt = mu[:, None, None] * (FFt - I) \
        + (lam * jnp.log(J) * J)[:, None, None] * I
    stress = PFt * (-4.0 * inv_dx * inv_dx * cfg.dt * cfg.volume)
    return Fe, stress


def _step_dense(cfg: MPMConfig, s: MPMState,
                grid_reduce=None) -> MPMState:
    """Cell-dense engine: one binning per step; P2G = 9 dense sums + grid
    shifts, G2P = 9 grid broadcasts — no element scatters/gathers on the
    hot path (same design as flip_apic._step_dense; positions are clamped
    to [2dx, (G-3)dx] so the 3x3 stencil never leaves the grid and the
    reference's bounds skip is reproduced by the zero-filled shifts).
    `grid_reduce` (e.g. lax.psum) merges per-device partial P2G grids —
    the multi-chip hook used by parallel/mpm_sharded.py."""
    from ..ops import cell_dense as cd

    n_p = cfg.n
    Gx, Gy = cfg.gx, cfg.gy
    dx = cfg.dx
    inv_dx = 1.0 / dx
    dt = cfg.dt
    mat = MATERIALS[cfg.material]
    dtype = s.pos.dtype
    K = cfg.capacity

    Xp = s.pos * inv_dx
    base = jnp.floor(Xp - 0.5).astype(jnp.int32)
    frac = Xp - base
    Fe, stress = _plastic_and_stress(cfg, s)
    m_v = cfg.particle_mass * s.vel

    bx = jnp.clip(base[:, 0], 0, Gx - 1)
    by = jnp.clip(base[:, 1], 0, Gy - 1)
    grid = cd.DenseGrid(Gx=Gx, Gy=Gy, cell=dx, K=K)
    cid = by * Gx + bx
    rank, ok, _ = cd.bin_rank(grid, s.pos, cid=cid)
    iota = jnp.arange(n_p, dtype=jnp.int32)
    didx = jnp.where(ok, cid * K + rank, Gx * Gy * K + iota)

    # one direct value scatter for all channels + a ones channel that
    # becomes the occupancy mask (skips bin_particles' inverse-map
    # scatter + slot gather)
    packed = jnp.concatenate([
        frac,                                    # 0: fx, 1: fy
        m_v,                                     # 2, 3
        stress.reshape(n_p, 4),                  # 4..7 (s00, s01, s10, s11)
        Fe.reshape(n_p, 4),                      # 8..11
        s.Jp[:, None],                           # 12
        s.pos,                                   # 13, 14
        jnp.ones((n_p, 1), dtype),               # 15: occupancy
    ], -1)
    d = jnp.zeros((Gx * Gy * K, 16), dtype).at[didx].set(
        packed, mode="drop", unique_indices=True).reshape(Gy, Gx, K, 16)
    occf = d[..., 15]
    dfx, dfy = d[..., 0], d[..., 1]
    wxs = _bspline_w(dfx)
    wys = _bspline_w(dfy)

    # ---- P2G ----
    mass2 = jnp.zeros((Gy, Gx), dtype)
    gu = jnp.zeros((Gy, Gx), dtype)
    gv = jnp.zeros((Gy, Gx), dtype)
    for ox in range(3):
        dposx = (ox - dfx) * dx
        for oy in range(3):
            dposy = (oy - dfy) * dx
            w = wxs[ox] * wys[oy] * occf
            fx = d[..., 4] * dposx + d[..., 5] * dposy
            fy = d[..., 6] * dposx + d[..., 7] * dposy
            mass2 = mass2 + cd.grid_shift(
                jnp.sum(w * cfg.particle_mass, -1), -oy, -ox)
            gu = gu + cd.grid_shift(jnp.sum(w * (d[..., 2] + fx), -1),
                                    -oy, -ox)
            gv = gv + cd.grid_shift(jnp.sum(w * (d[..., 3] + fy), -1),
                                    -oy, -ox)

    if grid_reduce is not None:
        mass2, gu, gv = grid_reduce((mass2, gu, gv))

    # ---- grid update (k_grid_update) ----
    has = mass2 > 0.0
    gu = jnp.where(has, gu / jnp.maximum(mass2, 1e-30), gu)
    gv = jnp.where(has, gv / jnp.maximum(mass2, 1e-30) - cfg.gravity * dt, gv)
    xsi = jnp.arange(Gx)[None, :]
    ysi = jnp.arange(Gy)[:, None]
    gu = jnp.where(has & (((xsi < 3) & (gu < 0)) | ((xsi > Gx - 4) & (gu > 0))),
                   0.0, gu)
    gv = jnp.where(has & (((ysi < 3) & (gv < 0)) | ((ysi > Gy - 4) & (gv > 0))),
                   0.0, gv)
    gu = jnp.where(has, gu, 0.0)
    gv = jnp.where(has, gv, 0.0)

    # ---- G2P ----
    shape = dfx.shape
    nvx = jnp.zeros(shape, dtype)
    nvy = jnp.zeros(shape, dtype)
    C00 = jnp.zeros(shape, dtype)
    C01 = jnp.zeros(shape, dtype)
    C10 = jnp.zeros(shape, dtype)
    C11 = jnp.zeros(shape, dtype)
    for ox in range(3):
        dposx = (ox - dfx) * dx
        for oy in range(3):
            dposy = (oy - dfy) * dx
            w = wxs[ox] * wys[oy] * occf
            gvx = cd.grid_shift(gu, oy, ox)[:, :, None]
            gvy = cd.grid_shift(gv, oy, ox)[:, :, None]
            nvx = nvx + w * gvx
            nvy = nvy + w * gvy
            C00 = C00 + 4.0 * inv_dx * w * gvx * dposx
            C01 = C01 + 4.0 * inv_dx * w * gvx * dposy
            C10 = C10 + 4.0 * inv_dx * w * gvy * dposx
            C11 = C11 + 4.0 * inv_dx * w * gvy * dposy

    f00, f01, f10, f11 = d[..., 8], d[..., 9], d[..., 10], d[..., 11]
    n00 = (1.0 + dt * C00) * f00 + dt * C01 * f10
    n01 = (1.0 + dt * C00) * f01 + dt * C01 * f11
    n10 = dt * C10 * f00 + (1.0 + dt * C11) * f10
    n11 = dt * C10 * f01 + (1.0 + dt * C11) * f11
    oldJ = jnp.maximum(f00 * f11 - f01 * f10, 1.0e-6)
    newJ = jnp.maximum(n00 * n11 - n01 * n10, 1.0e-6)
    if mat == 0:  # mud relaxes shear
        n01 = n01 * 0.96
        n10 = n10 * 0.96
    Jp2 = jnp.clip(d[..., 12] * oldJ / newJ, 0.05, 20.0)

    nx_ = jnp.clip(d[..., 13] + dt * nvx, 2.0 * dx, (Gx - 3.0) * dx)
    ny_ = jnp.clip(d[..., 14] + dt * nvy, 2.0 * dx, (Gy - 3.0) * dx)

    dense_out = jnp.stack(
        [nx_, ny_, nvx, nvy, n00, n01, n10, n11, Jp2], -1)
    got = dense_out.reshape(Gx * Gy * K, 9)[
        jnp.clip(didx, 0, Gx * Gy * K - 1)]
    old = jnp.concatenate(
        [s.pos, s.vel, s.F.reshape(n_p, 4), s.Jp[:, None]], -1)
    out = jnp.where(ok[:, None], got, old)

    return MPMState(
        pos=out[:, 0:2],
        vel=out[:, 2:4],
        F=out[:, 4:8].reshape(n_p, 2, 2),
        Jp=out[:, 8],
    )


def step(cfg: MPMConfig, s: MPMState, grid_reduce=None) -> MPMState:
    if cfg.engine == "dense":
        return _step_dense(cfg, s, grid_reduce)
    return _step_scatter(cfg, s, grid_reduce)


def overflow_count(cfg: MPMConfig, s: MPMState):
    """Particles beyond their cell's K capacity under the dense engine's
    binning (zero under engine='scatter', which is exact).  Reported by the
    CLI so clustered material can't silently lose physics."""
    from ..ops import cell_dense as cd

    if cfg.engine != "dense":
        return jnp.zeros((), jnp.int32)
    Xp = s.pos / cfg.dx
    base = jnp.floor(Xp - 0.5).astype(jnp.int32)
    bx = jnp.clip(base[:, 0], 0, cfg.gx - 1)
    by = jnp.clip(base[:, 1], 0, cfg.gy - 1)
    grid = cd.DenseGrid(Gx=cfg.gx, Gy=cfg.gy, cell=cfg.dx, K=cfg.capacity)
    return cd.bin_particles(grid, s.pos, cid=by * cfg.gx + bx).overflow


def run(cfg: MPMConfig, s: MPMState, n_steps: int) -> MPMState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
