"""2-D weakly-compressible SPH on the τ clock, 65k particles.

Behavioral spec: tau_sph.cu — cubic-spline kernel (W_cubic :105-116,
gradW_cubic :118-133); Tait EOS on log-density s = ln rho (:207-213);
pressure-gradient + Monaghan artificial viscosity forces (:215-266, beta
term omitted as in the reference); optional XSPH velocity smoothing
(:274-313); symplectic Euler with restitution-0.2 box walls (:324-355);
GPU rain emitter with an LCG hash overwriting random particle slots
(:377-391, fractional accumulator :706-716); jittered-lattice init
(:493-510); analytic CFL dt = CFL*h/(c0(1+2α)) capped by t*dτ (:666-668)
with exact τ bookkeeping per substep (:718-721).

Design: the atomicExch linked-list neighbor grid becomes the gather-free
cell-dense layout (fluidsims_tpu.ops.cell_dense): particles are sorted and
scattered into a (Gy, Gx, K) array-of-cells once per substep, the two
3x3-cell neighbor traversals become shifted-array (Gy, Gx, K, K) dense pair
blocks (pure VPU arithmetic, no gathers), and results return to particle
order with one small gather per output.  Static shapes, no data-dependent
loops, the whole step compiles as one jit.

Engines (cfg.engine): 'xla' is the cell-dense dataflow path above;
'exact' is a chunked all-pairs engine — O(n^2) but correct at ANY
occupancy; see the CAVEAT below for when that matters.

CAVEAT on the reference defaults (c0=1, gamma_eos=1, gravity=9.81): this
parameter set is NOT weakly compressible.  Tait with gamma=1 gives
hydrostatic equilibrium rho(y) = rho_top * exp(g*(H-y)/c0^2), i.e. ~30x
compression at the floor of the settled pool — measured occupancy
reaches ~430 particles per (2h)^2 cell by step 200, which matches that
equilibrium, so it is the CORRECT physics of these parameters, not a
blow-up.  The reference's linked lists tolerate unbounded occupancy
(its 3x3 loop just gets slow); the fixed-capacity dense layout instead
drops interactions beyond K per cell (overflow_count; the CLI warns
loudly).  For faithful long runs at these defaults use
engine='exact' (chunked all-pairs, correct at any occupancy), raise
--bin-capacity (pair cost grows as K^2), or use physically
weakly-compressible parameters (c0 >= 10*sqrt(g*H) keeps density
variation ~1% and occupancy near the seeded mean).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import BaseConfig
from ..ops import cell_dense as cd

__all__ = ["SPHConfig", "SPHState", "init", "step", "run", "density",
           "rasterize_counts", "raster_density"]


@dataclass(frozen=True)
class SPHConfig(BaseConfig):
    n: int = 1 << 16
    box_x: float = 1.0
    box_y: float = 1.0
    dtau: float = 1.0
    t0: float = 1.0
    cfl: float = 1.0
    rho0: float = 1.0
    c0: float = 1.0
    gamma_eos: float = 1.0
    h_mul: float = 2.0
    visc_alpha: float = 0.25
    gravity: float = 9.81
    use_visc: bool = True
    use_grav: bool = True
    visc_substeps: int = 1
    use_xsph: bool = False
    xsph_eps: float = 0.25
    rain: bool = True
    seed: int = 69420
    cell_capacity: int = 0   # 0 = auto (8x mean occupancy, min 32)
    engine: str = "xla"      # xla (cell-dense) | exact (all pairs)
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.box_x > 0 and self.box_y > 0, "box must be positive")
        self._require(self.c0 > 0, "c0 must be positive")
        self._require(self.visc_substeps >= 1, "visc_substeps >= 1")
        self._require(self.engine in ("xla", "exact"),
                      "engine must be xla or exact")

    @property
    def area(self):
        return self.box_x * self.box_y

    @property
    def mass(self):
        return self.rho0 * self.area / self.n

    @property
    def spacing(self):
        return math.sqrt(self.area / self.n)

    @property
    def h(self):
        return self.h_mul * self.spacing

    def grid(self) -> cd.DenseGrid:
        return cd.make_dense_grid(self.box_x, self.box_y, self.h, self.n,
                                  capacity=self.cell_capacity)


class SPHState(NamedTuple):
    pos: jnp.ndarray   # (n, 2)
    vel: jnp.ndarray   # (n, 2)
    t: jnp.ndarray
    tau: jnp.ndarray
    rain_carry: jnp.ndarray
    step_idx: jnp.ndarray


# ------------------------------ kernels ------------------------------------


def w_cubic(r, h):
    """2-D cubic spline kernel (tau_sph.cu:105-116)."""
    q = r / h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    q2 = q * q
    inner = alpha * (1.0 - 1.5 * q2 + 0.75 * q2 * q)
    t = 2.0 - q
    outer = alpha * 0.25 * t * t * t
    return jnp.where(q < 1.0, inner, jnp.where(q < 2.0, outer, 0.0))


def grad_w_cubic(rij, r, h):
    """Gradient of the cubic kernel w.r.t. x_i (tau_sph.cu:118-133).
    rij: (..., 2), r: (...)."""
    q = r / h
    alpha = 10.0 / (7.0 * math.pi * h * h)
    dWdq = jnp.where(
        q < 1.0,
        alpha * (-3.0 * q + 2.25 * q * q),
        alpha * (-0.75 * (2.0 - q) ** 2),
    )
    ok = (r > 1e-8) & (r < 2.0 * h)
    scale = jnp.where(ok, dWdq / (h * jnp.maximum(r, 1e-8)), 0.0)
    return rij * scale[..., None]


def tait_pressure(cfg, rho):
    ratio = rho / cfg.rho0
    p = (cfg.c0**2) * cfg.rho0 * (ratio**cfg.gamma_eos - 1.0) / cfg.gamma_eos
    return jnp.maximum(p, 0.0)


# ------------------------------- init --------------------------------------


def init(cfg: SPHConfig) -> SPHState:
    """Jittered lattice filling the lower 60% of the box
    (reset_particles, tau_sph.cu:493-510)."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    n_side = int(math.sqrt(n))
    nx = n_side
    ny = (n + n_side - 1) // n_side
    pad_x, pad_y = 0.05 * cfg.box_x, 0.05 * cfg.box_y
    width = cfg.box_x - 2 * pad_x
    height = 0.6 * cfg.box_y - pad_y

    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    x = pad_x + (ix + 0.5) / nx * width
    y = pad_y + (iy + 0.5) / ny * height
    x = x + (rng.random(n) - 0.5) * 0.2 * width / nx
    y = y + (rng.random(n) - 0.5) * 0.2 * height / ny

    dt = cfg.jax_dtype
    pos = jnp.asarray(np.stack([x, y], -1), dt)
    vel = jnp.zeros((n, 2), dt)
    return SPHState(
        pos=pos, vel=vel,
        t=jnp.asarray(cfg.t0, dt), tau=jnp.asarray(0.0, dt),
        rain_carry=jnp.asarray(0.0, dt),
        step_idx=jnp.asarray(0, jnp.int32),
    )


# ------------------------ cell-dense neighbor passes -----------------------
#
# Neighbor interactions run in the gather-free cell-dense layout
# (ops/cell_dense.py): one sort+scatter per substep, then every neighbor
# access is a shift of the (Gy, Gx, K) array and pair terms are dense
# (Gy, Gx, K, K) blocks — in place of the reference's atomicExch linked
# lists (tau_sph.cu:159-266).


def _pair_geometry(cfg, dpos, occ, oy, ox):
    """rij, r2 and validity for center-slot x neighbor-slot pairs of one
    3x3 cell offset. Shapes (Gy, Gx, K, K[, 2])."""
    npos = cd.shift_cells(dpos, oy, ox)
    nocc = cd.shift_cells(occ, oy, ox)
    rij = dpos[..., :, None, :] - npos[..., None, :, :]
    r2 = jnp.sum(rij * rij, axis=-1)
    valid = nocc[..., None, :] & (r2 < (2.0 * cfg.h) ** 2)
    return npos, nocc, rij, r2, valid


def density(cfg: SPHConfig, pos, grid=None, cells=None):
    """SPH density + Tait pressure on log-density
    (k_density_pressure_cell, tau_sph.cu:178-213)."""
    grid = grid or cfg.grid()
    cells = cells or cd.bin_particles(grid, pos)
    dpos = cd.scatter_field(grid, cells, pos)
    occ = cells.occ
    h = cfg.h

    rho_d = jnp.zeros(occ.shape, pos.dtype)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        _, _, _, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        w = jnp.where(valid, w_cubic(jnp.sqrt(jnp.maximum(r2, 0.0)), h), 0.0)
        rho_d = rho_d + cfg.mass * jnp.sum(w, axis=-1)

    rho = cd.gather_result(grid, cells, rho_d)
    s = jnp.log(jnp.maximum(rho, 1e-6))
    rho = jnp.exp(s)
    return s, rho, tait_pressure(cfg, rho), cells, grid


def forces(cfg: SPHConfig, pos, vel, s, press, grid, cells):
    """Pressure gradient + Monaghan viscosity + gravity
    (k_forces_cell, tau_sph.cu:215-266)."""
    h = cfg.h
    K = grid.K
    rho = jnp.exp(s)
    dpos = cd.scatter_field(grid, cells, pos)
    dvel = cd.scatter_field(grid, cells, vel)
    drho = cd.scatter_field(grid, cells, rho)
    dpress = cd.scatter_field(grid, cells, press)
    occ = cells.occ

    acc_d = jnp.zeros(dpos.shape, pos.dtype)
    not_self = ~jnp.eye(K, dtype=bool)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        npos, nocc, rij, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        if ox == 0 and oy == 0:
            valid = valid & not_self
        valid = valid & (r2 > 1e-16)

        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        gw = grad_w_cubic(rij, r, h)

        nrho = cd.shift_cells(drho, oy, ox)
        npress = cd.shift_cells(dpress, oy, ox)
        rho_i = jnp.maximum(drho[..., :, None], 1e-30)
        rho_j = jnp.maximum(nrho[..., None, :], 1e-30)
        p_i = dpress[..., :, None]
        p_j = npress[..., None, :]
        common = -cfg.mass * (p_i / (rho_i**2) + p_j / (rho_j**2))
        a = common[..., None] * gw

        if cfg.use_visc:
            nvel = cd.shift_cells(dvel, oy, ox)
            vij = dvel[..., :, None, :] - nvel[..., None, :, :]
            dot = jnp.sum(vij * rij, axis=-1)
            mu = (h * dot) / (r2 + 0.01 * h * h)
            rho_bar = 0.5 * (rho_i + rho_j)
            pi_ij = jnp.where(dot < 0.0,
                              (-cfg.visc_alpha * cfg.c0 * mu) / rho_bar, 0.0)
            a = a + (-cfg.mass * pi_ij)[..., None] * gw

        a = jnp.where(valid[..., None], a, 0.0)
        acc_d = acc_d + jnp.sum(a, axis=-2)

    acc = cd.gather_result(grid, cells, acc_d)
    if cfg.use_grav:
        acc = acc + jnp.asarray([0.0, -cfg.gravity], pos.dtype)
    return acc


def xsph(cfg: SPHConfig, pos, vel, s, grid, cells):
    """XSPH velocity smoothing (k_xsph_cell, tau_sph.cu:274-313).

    Note: like the reference, this runs with the PRE-integrate cell binning
    and densities but post-integrate positions/velocities."""
    h = cfg.h
    K = grid.K
    rho = jnp.exp(s)
    dpos = cd.scatter_field(grid, cells, pos)
    dvel = cd.scatter_field(grid, cells, vel)
    drho = cd.scatter_field(grid, cells, rho)
    occ = cells.occ

    dv_d = jnp.zeros(dpos.shape, pos.dtype)
    not_self = ~jnp.eye(K, dtype=bool)
    for ox, oy in cd.NEIGHBOR_OFFSETS_2D:
        npos, nocc, rij, r2, valid = _pair_geometry(cfg, dpos, occ, oy, ox)
        if ox == 0 and oy == 0:
            valid = valid & not_self
        w = jnp.where(valid, w_cubic(jnp.sqrt(jnp.maximum(r2, 0.0)), h), 0.0)
        nrho = cd.shift_cells(drho, oy, ox)
        rho_bar = 0.5 * (jnp.maximum(drho[..., :, None], 1e-30)
                         + jnp.maximum(nrho[..., None, :], 1e-30))
        nvel = cd.shift_cells(dvel, oy, ox)
        vij = nvel[..., None, :, :] - dvel[..., :, None, :]
        dv_d = dv_d + jnp.sum(
            ((cfg.mass / rho_bar) * w)[..., None] * vij, axis=-2
        )

    dv = cd.gather_result(grid, cells, dv_d)
    return cfg.xsph_eps * dv


def _integrate(cfg, pos, vel, acc, dt):
    """Symplectic Euler + restitution walls (k_integrate, tau_sph.cu:324-355)."""
    e = 0.2
    v = vel + acc * dt
    x = pos + v * dt

    lo_x = x[:, 0] < 0.0
    hi_x = x[:, 0] > cfg.box_x
    lo_y = x[:, 1] < 0.0
    hi_y = x[:, 1] > cfg.box_y
    x0 = jnp.where(lo_x, 0.0, jnp.where(hi_x, cfg.box_x, x[:, 0]))
    y0 = jnp.where(lo_y, 0.0, jnp.where(hi_y, cfg.box_y, x[:, 1]))
    vx = jnp.where(lo_x | hi_x, -e * v[:, 0], v[:, 0])
    vy = jnp.where(lo_y | hi_y, -e * v[:, 1], v[:, 1])
    return jnp.stack([x0, y0], -1), jnp.stack([vx, vy], -1)


_RAIN_MAX = 64  # static spawn-slot bound per substep


def _rain(cfg, pos, vel, nspawn, seed):
    """Rain emitter with the reference's LCG hash (k_rain, tau_sph.cu:377-391);
    spawns up to _RAIN_MAX particles by overwriting hashed slots."""
    k = jnp.arange(_RAIN_MAX, dtype=jnp.uint32)
    A = jnp.uint32(1664525)
    C = jnp.uint32(1013904223)
    s = jnp.uint32(seed) ^ (k * A + C)
    s = s * A + C
    rx = (s & jnp.uint32(0x00FFFFFF)).astype(pos.dtype) / 16777216.0
    x = rx * (cfg.box_x * 0.8) + 0.1 * cfg.box_x
    s = s * A + C
    ry = (s & jnp.uint32(0x00FFFFFF)).astype(pos.dtype) / 16777216.0
    y = cfg.box_y * (0.9 + 0.08 * ry)
    slots = (s % jnp.uint32(cfg.n)).astype(jnp.int32)

    active = k < nspawn.astype(jnp.uint32)
    tgt = jnp.where(active, slots, cfg.n)  # inactive -> dropped
    new_p = jnp.stack([x, y], -1)
    new_v = jnp.stack([jnp.zeros_like(x), jnp.full_like(x, -0.5 * cfg.c0)], -1)
    pos = pos.at[tgt].set(new_p, mode="drop")
    vel = vel.at[tgt].set(new_v, mode="drop")
    return pos, vel


def step(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """One frame step, on the engine `cfg.engine` names.

    `dtau` optionally overrides cfg.dtau as a traced scalar (it only enters
    the frame-level clock math, never a kernel body), so the interactive
    >/< nudges run without a recompile — the analog of tau_sph.cu:642-655's
    instant keys."""
    if cfg.engine == "exact":
        return _step_exact(cfg, st, dtau=dtau)
    return _step_xla(cfg, st, dtau=dtau)


_EXACT_FAR = 1.0e4   # pad particles parked far outside the box


def _exact_pairs(cfg, pos, chunk):
    """Pad to a chunk multiple and return per-component (n_pad,) arrays;
    pad particles sit at a far point so every real-vs-pad pair fails the
    r < 2h test (pad-vs-pad self pairs are discarded with the padding)."""
    n = pos.shape[0]
    CH = min(chunk, n)
    n_pad = -(-n // CH) * CH
    px = jnp.pad(pos[:, 0], (0, n_pad - n), constant_values=_EXACT_FAR)
    py = jnp.pad(pos[:, 1], (0, n_pad - n), constant_values=_EXACT_FAR)
    return px, py, CH, n_pad


def _exact_density(cfg, pos, chunk=1024):
    """All-pairs density + Tait pressure — k_density_pressure_cell
    semantics (tau_sph.cu:178-213) with the neighbor enumeration exact
    instead of capacity-bounded.  Chunked (CH, n) per-component pair
    blocks (the lane-major nbody pattern)."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(cfg, pos, chunk)

    def chunk_rho(pc):
        dx = pc[0][:, None] - px[None, :]
        dy = pc[1][:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        valid = r2 < (2.0 * h) ** 2
        w = jnp.where(valid,
                      w_cubic(jnp.sqrt(jnp.maximum(r2, 0.0)), h), 0.0)
        return cfg.mass * jnp.sum(w, axis=1)

    stacked = jnp.stack([px, py]).reshape(2, -1, CH).transpose(1, 0, 2)
    rho = lax.map(chunk_rho, stacked).reshape(-1)[:pos.shape[0]]
    s = jnp.log(jnp.maximum(rho, 1e-6))
    rho = jnp.exp(s)
    return s, rho, tait_pressure(cfg, rho)


def _exact_forces(cfg, pos, vel, rho, press, chunk=1024):
    """All-pairs pressure-gradient + Monaghan viscosity
    (k_forces_cell, tau_sph.cu:215-266), same per-pair math as
    forces()."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(cfg, pos, chunk)
    pad1 = lambda a, v: jnp.pad(a, (0, n_pad - a.shape[0]),  # noqa: E731
                                constant_values=v)
    vx = pad1(vel[:, 0], 0.0)
    vy = pad1(vel[:, 1], 0.0)
    rhop = pad1(rho, 1.0)
    prp = pad1(press, 0.0)

    def chunk_acc(blk):
        cx, cy, cvx, cvy, crho, cpr = blk
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        valid = (r2 < (2.0 * h) ** 2) & (r2 > 1e-16)
        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        q = r / h
        alpha = 10.0 / (7.0 * math.pi * h * h)
        dWdq = jnp.where(q < 1.0,
                         alpha * (-3.0 * q + 2.25 * q * q),
                         alpha * (-0.75 * (2.0 - q) ** 2))
        okg = (r > 1e-8) & (r < 2.0 * h)
        scale = jnp.where(okg, dWdq / (h * jnp.maximum(r, 1e-8)), 0.0)

        rho_i = jnp.maximum(crho[:, None], 1e-30)
        rho_j = jnp.maximum(rhop[None, :], 1e-30)
        common = -cfg.mass * (cpr[:, None] / (rho_i ** 2)
                              + prp[None, :] / (rho_j ** 2))
        if cfg.use_visc:
            vijx = cvx[:, None] - vx[None, :]
            vijy = cvy[:, None] - vy[None, :]
            dot = vijx * dx + vijy * dy
            mu = (h * dot) / (r2 + 0.01 * h * h)
            rho_bar = 0.5 * (rho_i + rho_j)
            pi_ij = jnp.where(
                dot < 0.0, (-cfg.visc_alpha * cfg.c0 * mu) / rho_bar, 0.0)
            common = common - cfg.mass * pi_ij
        c = jnp.where(valid, common * scale, 0.0)
        return jnp.stack([jnp.sum(c * dx, axis=1),
                          jnp.sum(c * dy, axis=1)], -1)

    blk = jnp.stack([px, py, vx, vy, rhop, prp])
    blk = blk.reshape(6, -1, CH).transpose(1, 0, 2)
    acc = lax.map(chunk_acc, blk).reshape(-1, 2)[:pos.shape[0]]
    if cfg.use_grav:
        acc = acc + jnp.asarray([0.0, -cfg.gravity], pos.dtype)
    return acc


def _exact_xsph(cfg, pos, vel, rho, chunk=1024):
    """All-pairs XSPH smoothing (k_xsph_cell, tau_sph.cu:274-313)."""
    h = cfg.h
    px, py, CH, n_pad = _exact_pairs(cfg, pos, chunk)
    pad1 = lambda a, v: jnp.pad(a, (0, n_pad - a.shape[0]),  # noqa: E731
                                constant_values=v)
    vx = pad1(vel[:, 0], 0.0)
    vy = pad1(vel[:, 1], 0.0)
    rhop = pad1(rho, 1.0)

    def chunk_dv(blk):
        cx, cy, cvx, cvy, crho = blk
        dx = cx[:, None] - px[None, :]
        dy = cy[:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        valid = (r2 < (2.0 * h) ** 2) & (r2 > 1e-16)
        w = jnp.where(valid,
                      w_cubic(jnp.sqrt(jnp.maximum(r2, 0.0)), h), 0.0)
        rho_bar = 0.5 * (jnp.maximum(crho[:, None], 1e-30)
                         + jnp.maximum(rhop[None, :], 1e-30))
        f = (cfg.mass / rho_bar) * w
        return jnp.stack([jnp.sum(f * (vx[None, :] - cvx[:, None]), 1),
                          jnp.sum(f * (vy[None, :] - cvy[:, None]), 1)], -1)

    blk = jnp.stack([px, py, vx, vy, rhop]).reshape(5, -1, CH)
    dv = lax.map(chunk_dv, blk.transpose(1, 0, 2)).reshape(-1, 2)
    return cfg.xsph_eps * dv[:pos.shape[0]]


def _step_exact(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """_step_xla with the neighbor sums exact (all pairs, no capacity)."""
    K = cfg.visc_substeps
    dt_try = st.t * (cfg.dtau if dtau is None else dtau)
    dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
    dt_sub = jnp.minimum(dt_try, dt_cfl) / K

    pos, vel = st.pos, st.vel
    rain_carry = st.rain_carry
    t = st.t
    dtau_accum = jnp.asarray(0.0, st.t.dtype)

    for k in range(K):
        s, rho, press = _exact_density(cfg, pos)
        acc = _exact_forces(cfg, pos, vel, rho, press)
        pos, vel = _integrate(cfg, pos, vel, acc, dt_sub)
        if cfg.use_xsph and cfg.xsph_eps > 0.0:
            dv = _exact_xsph(cfg, pos, vel, rho)
            vel = vel + dv
        if cfg.rain:
            rain_carry = rain_carry + 0.02 * cfg.n * dt_sub
            nspawn = jnp.minimum(jnp.floor(rain_carry), _RAIN_MAX).astype(
                jnp.int32)
            rain_carry = rain_carry - nspawn
            pos, vel = _rain(cfg, pos, vel, nspawn, cfg.seed + st.step_idx)
        dtau_accum = dtau_accum + dt_sub / jnp.maximum(t, 1e-9)
        t = cfg.t0 * jnp.exp(st.tau + dtau_accum)

    return SPHState(pos=pos, vel=vel, t=t, tau=st.tau + dtau_accum,
                    rain_carry=rain_carry, step_idx=st.step_idx + 1)


def _step_xla(cfg: SPHConfig, st: SPHState, dtau=None) -> SPHState:
    """One frame step = K substeps of build-cells -> density -> forces ->
    integrate -> (xsph) -> (rain), with τ bookkeeping per substep
    (main loop, tau_sph.cu:659-722)."""
    K = cfg.visc_substeps
    dt_try = st.t * (cfg.dtau if dtau is None else dtau)
    dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
    dt_eff = jnp.minimum(dt_try, dt_cfl)
    dt_sub = dt_eff / K

    grid = cfg.grid()
    pos, vel = st.pos, st.vel
    rain_carry = st.rain_carry
    t = st.t
    dtau_accum = jnp.asarray(0.0, st.t.dtype)

    for k in range(K):
        s, rho, press, cl, _ = density(cfg, pos, grid)
        acc = forces(cfg, pos, vel, s, press, grid, cl)
        pos, vel = _integrate(cfg, pos, vel, acc, dt_sub)

        if cfg.use_xsph and cfg.xsph_eps > 0.0:
            # The reference runs XSPH on post-integrate positions but with
            # the PRE-integrate cell list and densities (tau_sph.cu:698-704:
            # cellHead/next and d.s are not rebuilt after k_integrate).
            dv = xsph(cfg, pos, vel, s, grid, cl)
            vel = vel + dv

        if cfg.rain:
            rain_carry = rain_carry + 0.02 * cfg.n * dt_sub
            nspawn = jnp.minimum(jnp.floor(rain_carry), _RAIN_MAX).astype(
                jnp.int32
            )
            rain_carry = rain_carry - nspawn
            pos, vel = _rain(cfg, pos, vel, nspawn,
                             cfg.seed + st.step_idx)

        dtau_actual = dt_sub / jnp.maximum(t, 1e-9)
        dtau_accum = dtau_accum + dtau_actual
        t = cfg.t0 * jnp.exp(st.tau + dtau_accum)

    return SPHState(
        pos=pos, vel=vel, t=t, tau=st.tau + dtau_accum,
        rain_carry=rain_carry, step_idx=st.step_idx + 1,
    )


def run(cfg: SPHConfig, st: SPHState, n_steps: int, dtau=None) -> SPHState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda s: step(cfg, s, dtau=dtau), st, n_steps)


def overflow_count(cfg: SPHConfig, st: SPHState) -> jnp.ndarray:
    """Particles currently beyond their cell's K capacity (dropped from
    interactions by the cell-dense layout).  Diagnostic only — the CLI
    reports it so clustered distributions can't silently lose physics
    relative to the reference's unbounded linked lists (tau_sph.cu:165-176).
    """
    if cfg.engine == "exact":
        return jnp.zeros((), jnp.int32)
    return cd.bin_particles(cfg.grid(), st.pos).overflow


def raster_density(cfg: SPHConfig, pos, W: int = 64, H: int = 64,
                   chunk: int = 4096):
    """Exact (all-pairs, unbounded-neighbor) SPH density rho(x) =
    sum_j m W(|x - x_j|) evaluated at W x H raster cell centers — the
    field the renderer shows, and the observable the dropped-pair error
    study (tools/sph_error_study.py) and its gate test compare across
    engines.  Chunked like _exact_density; works at any occupancy."""
    dt = pos.dtype
    gx = (jnp.arange(W, dtype=dt) + 0.5) / W * cfg.box_x
    gy = (jnp.arange(H, dtype=dt) + 0.5) / H * cfg.box_y
    X, Y = jnp.meshgrid(gx, gy)
    pts = jnp.stack([X.ravel(), Y.ravel()], -1)
    px, py = pos[:, 0], pos[:, 1]
    h = cfg.h

    def chunk_rho(pc):
        dx = pc[:, 0][:, None] - px[None, :]
        dy = pc[:, 1][:, None] - py[None, :]
        r2 = dx * dx + dy * dy
        w = jnp.where(r2 < (2.0 * h) ** 2,
                      w_cubic(jnp.sqrt(jnp.maximum(r2, 0.0)), h), 0.0)
        return cfg.mass * jnp.sum(w, axis=1)

    n_pts = pts.shape[0]
    ch = min(chunk, n_pts)
    pad = -(-n_pts // ch) * ch - n_pts
    pts_p = jnp.pad(pts, ((0, pad), (0, 0)), constant_values=_EXACT_FAR)
    rho = lax.map(chunk_rho, pts_p.reshape(-1, ch, 2)).ravel()[:n_pts]
    return rho.reshape(H, W)


def rasterize_counts(cfg: SPHConfig, pos, W: int, H: int):
    """Particle counts on a 2x-vertical terminal grid
    (k_rasterize, tau_sph.cu:363-374)."""
    cx = (pos[:, 0] / cfg.box_x * (W - 1)).astype(jnp.int32)
    sy = ((cfg.box_y - pos[:, 1]) / cfg.box_y * (2 * H - 1)).astype(jnp.int32)
    ok = (cx >= 0) & (cx < W) & (sy >= 0) & (sy < 2 * H)
    flat = jnp.where(ok, sy * W + cx, 2 * H * W)
    grid = jnp.zeros(2 * H * W, jnp.int32).at[flat].add(1, mode="drop")
    return grid.reshape(2 * H, W)
