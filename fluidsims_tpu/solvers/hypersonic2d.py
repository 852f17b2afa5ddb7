"""Flagship 2-D hypersonic compressible Euler solver (MUSCL-Hancock + HLLC).

Behavioral spec: tau_hypersonic_cuda.cu — double-precision 8192x1024 flow
past a sphere-cone capsule with explicit 4th-order-stencil diffusion:
  * config + validation      tau_hypersonic_cuda.cu:37-50, 1394-1409, 1482-1639
  * geometry mask            :740-770 (SDF rasterized, rounded by Rb)
  * inflow left column       :772-784
  * CFL dt from max wavespeed:786-847, 1852-1869
  * MUSCL predict face states:849-962
  * HLLC face fluxes         :964-1030
  * update + diffusion + fix :1032-1176

Design choices (vs the CUDA pipeline):
  * One fused dataflow step: the predict/flux/update kernels become a single
    jit region of whole-array shifts + selects; XLA fuses them so the four
    face-state SoA arrays and two flux SoA arrays that the reference streams
    through HBM never need to be materialized as separate passes.
  * dt stays on device: the reference's per-step device->host wavespeed
    readback (:1846-1850) is replaced by a traced `jnp.max` feeding the
    update directly — the whole multi-step loop is one `lax.scan`.
  * Branch-free BCs: neighbor_or_wall's branches (:266-290) become shifted
    arrays + mask selects evaluated for the entire grid at once.
  * float32 by default; dtype is configurable and the regression gate
    compares against a float64 NumPy oracle at f32 tolerance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.clock import cfl_dt
from ..core.config import BaseConfig
from ..ops import euler2d as e2
from ..ops.euler2d import Cons, Prim
from ..ops.riemann import hllc
from ..ops.sdf import sd_sphere_cone_capsule, spherecone_xb
from ..ops.shift import shift_clamped

__all__ = [
    "Hypersonic2DConfig",
    "Hypersonic2DState",
    "default_config",
    "build_mask",
    "init",
    "step",
    "run",
    "max_wavespeed",
    "compute_dt",
]


@dataclass(frozen=True)
class Hypersonic2DConfig(BaseConfig):
    nx: int = 8192
    ny: int = 1024
    gamma: float = 1.1
    cfl: float = 0.25
    visc_nu: float = 5e-2
    visc_rho: float = 5e-2
    visc_e: float = 2e-2
    inflow_mach: float = 25.0
    geom_x0: float = 125.0
    geom_cy: float = 512.0
    geom_Rb: float = 1024.0 / 12.0
    geom_Rn: float = 1024.0 / 24.0
    geom_theta: float = math.pi / 4.0
    steps_per_frame: int = 2
    dtype: str = "float32"

    def validate(self):
        # Two-stage validation mirroring tau_hypersonic_cuda.cu:1538-1639.
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.gamma > 1.0, f"gamma {self.gamma} must be > 1")
        self._require(self.cfl > 0.0, "cfl must be > 0")
        self._require(self.visc_nu >= 0.0, "visc_nu must be >= 0")
        self._require(self.visc_rho >= 0.0, "visc_rho must be >= 0")
        self._require(self.visc_e >= 0.0, "visc_e must be >= 0")
        self._require(self.inflow_mach > 0.0, "inflow_mach must be > 0")
        self._require(
            0 < self.steps_per_frame <= 1024, "steps_per_frame must be in [1,1024]"
        )
        self._require(math.isfinite(self.geom_x0), "geom_x0 must be finite")
        self._require(math.isfinite(self.geom_cy), "geom_cy must be finite")
        self._require(self.geom_Rb > 0.0, "geom_Rb must be > 0")
        self._require(self.geom_Rn > 0.0, "geom_Rn must be > 0")
        self._require(
            0.0 < self.geom_theta < 0.5 * math.pi, "geom_theta must be in (0, pi/2)"
        )
        # Geometry tangency: base radius must reach past the sphere tangent.
        rt = self.geom_Rn * math.cos(self.geom_theta)
        self._require(
            self.geom_Rb >= rt,
            f"geom_Rb {self.geom_Rb} below tangent radius {rt}; "
            "require Rb >= Rn*cos(theta)",
        )
        tt = math.tan(self.geom_theta)
        self._require(math.isfinite(tt) and tt > 0.0, "tan(theta) must be positive")
        xb = spherecone_xb(self.geom_Rb, self.geom_Rn, self.geom_theta)
        xt = self.geom_Rn * (1.0 - math.sin(self.geom_theta))
        self._require(math.isfinite(xb) and xb >= xt, "cone base behind tangent point")

    @property
    def nu_max(self) -> float:
        return max(self.visc_nu, self.visc_rho, self.visc_e)


def default_config(nx: int = 8192, ny: int = 1024, **kw) -> Hypersonic2DConfig:
    """Defaults scaled to the grid as in tau_hypersonic_cuda.cu:1394-1409
    (cy = ny/2, Rb = ny/12, Rn = ny/24)."""
    base = dict(
        nx=nx,
        ny=ny,
        geom_x0=125.0 * nx / 8192.0 if nx != 8192 else 125.0,
        geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0,
        geom_Rn=ny / 24.0,
    )
    base.update(kw)
    return Hypersonic2DConfig(**base)


class Hypersonic2DState(NamedTuple):
    U: Cons                  # conserved fields, each (ny, nx)
    mask: jnp.ndarray        # bool (ny, nx), True = solid
    t: jnp.ndarray           # sim time (scalar)


def _inflow(cfg: Hypersonic2DConfig) -> Prim:
    return e2.inflow_prim(cfg.gamma, cfg.inflow_mach, cfg.jax_dtype)


def build_mask(cfg: Hypersonic2DConfig) -> jnp.ndarray:
    """Rasterize the rounded sphere-cone SDF to a solid mask
    (tau_hypersonic_cuda.cu:740-765): sd = capsule_sd - Rb, clipped behind
    the base plane."""
    dt = cfg.jax_dtype
    x = jnp.arange(cfg.nx, dtype=dt) - dt.type(cfg.geom_x0)
    y = jnp.arange(cfg.ny, dtype=dt) - dt.type(cfg.geom_cy)
    X, Y = jnp.meshgrid(x, y)  # (ny, nx)
    xb = spherecone_xb(cfg.geom_Rb, cfg.geom_Rn, cfg.geom_theta)
    sd = sd_sphere_cone_capsule(X, Y, cfg.geom_Rb, cfg.geom_Rn, cfg.geom_theta)
    sd = sd - cfg.geom_Rb
    sd = jnp.maximum(sd, X - xb)
    return sd < 0.0


def init(cfg: Hypersonic2DConfig) -> Hypersonic2DState:
    """Fill the domain with inflow; solid cells hold the stagnant state
    (rho, 0, 0, p) (tau_hypersonic_cuda.cu:767-769)."""
    mask = build_mask(cfg)
    infl = _inflow(cfg)
    shape = (cfg.ny, cfg.nx)
    dt = cfg.jax_dtype

    def full(v):
        return jnp.full(shape, v, dtype=dt)

    fluid = e2.prim_to_cons(
        Prim(full(infl.rho), full(infl.u), full(infl.v), full(infl.p)), cfg.gamma
    )
    solid = e2.prim_to_cons(
        Prim(full(infl.rho), full(0.0), full(0.0), full(infl.p)), cfg.gamma
    )
    U = e2.c_where(mask, solid, fluid)
    return Hypersonic2DState(U=U, mask=mask, t=jnp.asarray(0.0, dt))


# ---------------------------------------------------------------------------
# Branch-free neighbor access with boundary conditions
# ---------------------------------------------------------------------------


def _neighbor(cfg, U: Cons, mask, center_prim: Prim, dy: int, dx: int) -> Cons:
    """Whole-grid neighbor_or_wall (tau_hypersonic_cuda.cu:266-290):
    y edge-clamped; x<0 -> inflow; x>=nx -> last column (edge clamp);
    in-bounds solid neighbor -> no-slip ghost of the center cell."""
    Un = Cons(*(shift_clamped(f, dy, dx) for f in U))
    mn = shift_clamped(mask, dy, dx)

    ghost = e2.prim_to_cons(e2.wall_ghost(center_prim), cfg.gamma)

    if dx != 0:
        # The wall-ghost substitution only applies where the x-neighbor was
        # in-bounds (the reference checks x bounds before the mask).
        nx = cfg.nx
        col = np.arange(nx) + dx
        in_x = jnp.asarray((col >= 0) & (col < nx))
        sel = mn & in_x[None, :]
    else:
        sel = mn
    out = e2.c_where(sel, ghost, Un)

    if dx < 0:
        # First |dx| columns read past the inflow boundary.
        infl = e2.prim_to_cons(_inflow(cfg), cfg.gamma)
        nx = cfg.nx
        col_inflow = jnp.asarray(np.arange(nx) + dx < 0)
        out = e2.c_where(col_inflow[None, :], _bcast(infl, out.rho.shape), out)
    return out


def _bcast(c: Cons, shape) -> Cons:
    return Cons(*(jnp.broadcast_to(f, shape) for f in c))


# ---------------------------------------------------------------------------
# Padded-core formulation
#
# The step is expressed as: (1) resolve all x/y boundary conditions into a
# halo-2 padded copy of the state (pad_bc), then (2) a purely local core
# (step_core_padded) in which every neighbor access is a static slice and
# the only remaining BC logic is the wall-ghost mask select.  The ghost
# columns are constant along x (inflow / outflow copy), so MUSCL
# reconstruction inside them degenerates to exactly the reference's
# boundary states (proof mirrors parallel/hypersonic2d_sharded.py, which
# uses the same trick across chips).
# ---------------------------------------------------------------------------

PAD = 2  # stencil reach: MUSCL(1) chained through faces + diffusion(2)


def pad_bc(cfg, U: Cons, mask):
    """Halo-2 padded state with BCs resolved: y edge-clamp, x<0 inflow,
    x>=nx outflow copy of the last column; padded mask is edge-clamped in y
    and False in the x pads (the reference never mask-checks x ghosts,
    tau_hypersonic_cuda.cu:277-283)."""
    infl = e2.prim_to_cons(_inflow(cfg), cfg.gamma)

    def padf(f, left_val):
        f = jnp.pad(f, ((PAD, PAD), (0, 0)), mode="edge")
        f = jnp.pad(f, ((0, 0), (0, PAD)), mode="edge")
        left = jnp.full((f.shape[0], PAD), left_val, f.dtype)
        return jnp.concatenate([left, f], axis=1)

    Up = Cons(*(padf(f, v) for f, v in zip(U, infl)))
    mp = jnp.pad(mask, ((PAD, PAD), (0, 0)), mode="edge")
    mp = jnp.pad(mp, ((0, 0), (PAD, PAD)), mode="constant",
                 constant_values=False)
    return Up, mp


def _win(f, y0, x0, h, w):
    return f[y0:y0 + h, x0:x0 + w]


def _cwin(c: Cons, y0, x0, h, w) -> Cons:
    return Cons(*(_win(f, y0, x0, h, w) for f in c))


def step_core_padded(cfg, Up: Cons, Mp, dt) -> Cons:
    """The local physics update on a halo-2 padded block: MUSCL predict ->
    HLLC face fluxes -> conservative update + diffusion -> positivity fix.
    Returns the new interior state (shape = padded minus 2*PAD each dim).
    Pure slicing + elementwise ops.

    The primitive decode is hoisted: cons_to_prim runs ONCE on the whole
    padded block and every window takes slices of it — bitwise-identical
    to per-window decodes (elementwise ops commute with slicing), and it
    deletes ~6 grid-sized redundant decodes the compiler cannot CSE
    (shifted windows are distinct expressions)."""
    hp, wp = Up.rho.shape
    H = hp - 2 * PAD
    W = wp - 2 * PAD
    half_dt = 0.5 * dt

    # one decode of the whole padded block; all center-state prims below
    # are windows of this
    Pp = e2.cons_to_prim(Up, cfg.gamma)

    def _pwin(y0, x0, h, w) -> Prim:
        return Prim(*(_win(f, y0, x0, h, w) for f in Pp))

    def predict_axis(axis):
        # predicted (low, high) face states for the extended cell range:
        # x axis: cells [-1, W] x rows [0, H); y axis: cols [0, W) x rows
        # [-1, H]
        if axis == 0:
            h, w = H, W + 2
            y0, x0 = PAD, PAD - 1
            dy, dx = 0, 1
        else:
            h, w = H + 2, W
            y0, x0 = PAD - 1, PAD
            dy, dx = 1, 0

        qc = _pwin(y0, x0, h, w)

        def nbr(sgn):
            Un = _cwin(Up, y0 + sgn * dy, x0 + sgn * dx, h, w)
            mn = _win(Mp, y0 + sgn * dy, x0 + sgn * dx, h, w)
            ghost = e2.prim_to_cons(e2.wall_ghost(qc), cfg.gamma)
            return e2.c_where(mn, ghost, Un)

        qm = e2.cons_to_prim(nbr(-1), cfg.gamma)
        qp = e2.cons_to_prim(nbr(+1), cfg.gamma)
        qL, qR = e2.reconstruct_faces(qm, qc, qp)

        FL = e2.flux(e2.prim_to_cons(qL, cfg.gamma), cfg.gamma, axis)
        FR = e2.flux(e2.prim_to_cons(qR, cfg.gamma), cfg.gamma, axis)
        dF = e2.c_sub(FR, FL)
        pL = e2.clamp_prim(e2.half_step_predict(qL, dF, half_dt, cfg.gamma))
        pR = e2.clamp_prim(e2.half_step_predict(qR, dF, half_dt, cfg.gamma))
        return (e2.prim_to_cons(pL, cfg.gamma),
                e2.prim_to_cons(pR, cfg.gamma))

    # ---- x faces: (H, W+1) ----
    xL, xR = predict_axis(0)
    fluidL = ~_win(Mp, PAD, PAD - 1, H, W + 1)   # cells -1..W-1
    fluidR = ~_win(Mp, PAD, PAD, H, W + 1)       # cells 0..W
    ghostL = e2.prim_to_cons(
        e2.wall_ghost(_pwin(PAD, PAD, H, W + 1)), cfg.gamma)
    ghostR = e2.prim_to_cons(
        e2.wall_ghost(_pwin(PAD, PAD - 1, H, W + 1)), cfg.gamma)
    UL = e2.c_where(fluidL, Cons(*(f[:, :-1] for f in xR)), ghostL)
    UR = e2.c_where(fluidR, Cons(*(f[:, 1:] for f in xL)), ghostR)
    Fx = hllc(UL, UR, cfg.gamma, axis=0)
    zero = Cons(*(jnp.zeros_like(Fx.rho) for _ in range(4)))
    Fx = e2.c_where(fluidL | fluidR, Fx, zero)

    # ---- y faces: (H+1, W) ----
    yL, yR = predict_axis(1)
    fluidB = ~_win(Mp, PAD - 1, PAD, H + 1, W)
    fluidT = ~_win(Mp, PAD, PAD, H + 1, W)
    ghostB = e2.prim_to_cons(
        e2.wall_ghost(_pwin(PAD, PAD, H + 1, W)), cfg.gamma)
    ghostT = e2.prim_to_cons(
        e2.wall_ghost(_pwin(PAD - 1, PAD, H + 1, W)), cfg.gamma)
    UB = e2.c_where(fluidB, Cons(*(f[:-1, :] for f in yR)), ghostB)
    UT = e2.c_where(fluidT, Cons(*(f[1:, :] for f in yL)), ghostT)
    Gy = hllc(UB, UT, cfg.gamma, axis=1)
    zero = Cons(*(jnp.zeros_like(Gy.rho) for _ in range(4)))
    Gy = e2.c_where(fluidB | fluidT, Gy, zero)

    # ---- conservative update ----
    Uc = _cwin(Up, PAD, PAD, H, W)
    maskc = _win(Mp, PAD, PAD, H, W)
    center = _pwin(PAD, PAD, H, W)

    Un = Cons(*(
        u - dt * (f[:, 1:] - f[:, :-1]) - dt * (g[1:, :] - g[:-1, :])
        for u, f, g in zip(Uc, Fx, Gy)
    ))

    # ---- diffusion (4th-order 5-tap, halo 2) ----
    inv12 = 1.0 / 12.0
    ghost_c = e2.prim_to_cons(e2.wall_ghost(center), cfg.gamma)

    def dnbr(dy, dx):
        Unb = _cwin(Up, PAD + dy, PAD + dx, H, W)
        mnb = _win(Mp, PAD + dy, PAD + dx, H, W)
        return e2.c_where(mnb, ghost_c, Unb)

    def d2(axis):
        dy, dx = (0, 1) if axis == 0 else (1, 0)
        m2 = dnbr(-2 * dy, -2 * dx)
        m1 = dnbr(-dy, -dx)
        p1 = dnbr(dy, dx)
        p2 = dnbr(2 * dy, 2 * dx)
        return Cons(*(
            (-a + 16.0 * b - 30.0 * c + 16.0 * d - e) * inv12
            for a, b, c, d, e in zip(m2, m1, Uc, p1, p2)
        ))

    lap = e2.c_add(d2(0), d2(1))
    Un = Cons(
        rho=Un.rho + (cfg.visc_rho * dt) * lap.rho,
        mx=Un.mx + (cfg.visc_nu * dt) * lap.mx,
        my=Un.my + (cfg.visc_nu * dt) * lap.my,
        E=Un.E + (cfg.visc_e * dt) * lap.E,
    )

    # ---- positivity / finiteness repair ----
    Un = Un._replace(rho=jnp.maximum(Un.rho, e2.EPS_RHO))
    pp = e2.cons_to_prim(Un, cfg.gamma)
    bad = (
        (pp.p <= e2.EPS_P)
        | ~jnp.isfinite(pp.p) | ~jnp.isfinite(pp.rho)
        | ~jnp.isfinite(pp.u) | ~jnp.isfinite(pp.v)
    )
    fixed = e2.prim_to_cons(e2.clamp_prim(pp), cfg.gamma)
    Un = e2.c_where(bad, fixed, Un)

    # solid cells keep their state
    return e2.c_where(maskc, Uc, Un)


# ---------------------------------------------------------------------------
# Step pipeline
# ---------------------------------------------------------------------------


def max_wavespeed(cfg, U: Cons, mask):
    """Max |u|+a, |v|+a over fluid cells — the reference's two-stage shared
    memory reduction (tau_hypersonic_cuda.cu:786-847) is a single jnp.max."""
    p = e2.cons_to_prim(U, cfg.gamma)
    a = e2.sound_speed(p, cfg.gamma)
    s = jnp.maximum(jnp.abs(p.u) + a, jnp.abs(p.v) + a)
    s = jnp.where(jnp.isfinite(s), s, 1e-12)
    s = jnp.where(mask, 1e-12, s)
    return jnp.maximum(jnp.max(s), 1e-12)


def compute_dt(cfg, U: Cons, mask):
    return cfl_dt(max_wavespeed(cfg, U, mask), cfg.cfl, dx=1.0, nu_max=cfg.nu_max)


def step(
    cfg: Hypersonic2DConfig,
    s: Hypersonic2DState,
    inflow_cols=None,
    wavespeed_reduce=None,
) -> Hypersonic2DState:
    """One full physics step — the reference's 5-kernel sequence
    (tau_hypersonic_cuda.cu:1833-1889) as one fused jit region:
    inflow column -> on-device CFL dt -> pad_bc -> step_core_padded.

    `inflow_cols` / `wavespeed_reduce` are hooks for the sharded multi-chip
    path (fluidsims_tpu.parallel): a traced bool column mask selecting where
    the inflow BC applies (default: global column 0), and a cross-device
    reduction (lax.pmax over the mesh axis) for the CFL wavespeed.
    """
    U, mask = s.U, s.mask

    # Inflow left column (k_apply_inflow_left, :772-784).
    infl = e2.prim_to_cons(_inflow(cfg), cfg.gamma)
    if inflow_cols is None:
        inflow_cols = jnp.asarray(np.arange(cfg.nx) == 0)[None, :]
    first_col = inflow_cols & ~mask
    U = e2.c_where(first_col, _bcast(infl, U.rho.shape), U)

    # CFL dt, on device (:1852-1869).
    maxs = max_wavespeed(cfg, U, mask)
    if wavespeed_reduce is not None:
        maxs = wavespeed_reduce(maxs)
    dt = cfl_dt(maxs, cfg.cfl, dx=1.0, nu_max=cfg.nu_max)

    Up, Mp = pad_bc(cfg, U, mask)
    Un = step_core_padded(cfg, Up, Mp, dt)

    return Hypersonic2DState(U=Un, mask=mask, t=s.t + dt)


def run(cfg: Hypersonic2DConfig, s: Hypersonic2DState, n_steps: int):
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
