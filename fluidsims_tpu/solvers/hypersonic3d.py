"""3-D hypersonic flow past a sphere with two-temperature vibrational
nonequilibrium, WENO5 + HLLC, log-space state, τ-clock with feedback dτ.

Behavioral spec: tau_hypersonic_3d_cuda.cu —
  * log-space state ξ=ln ρ, φ=asinh(u/u_ref), λ=ln p, ζ=ln e_vib
    (:109-171, encode/decode :213-232, store :1353-1358)
  * two-temperature EOS: Et carries kinetic + thermal + vibrational energy;
    T_v recovered from e_vib by a 3-iteration Newton solve (:191-211, 234-262)
  * WENO5 faces (:534-598) + HLLC with entropy-fixed wavespeeds (:366-374)
    and shock-sensor HLL blending scaled by flow alignment (:376-381, 383-460)
  * solid-aware stencil degradation: wall-mirrored Riemann problem at faces
    touching the sphere, minmod... actually first-order (L,R)=(q_{i-1},q_i)
    pair when any solid sits in the WENO stencil line (:1095-1163)
  * isothermal wall ghost state (apply_wall :511-521); inflow at x<0,
    transmissive outflow with subsonic pressure relaxation at x>=nx
    (:691-722); y, z periodic (:729-730)
  * Landau–Teller vibrational relaxation toward e_v^eq(T) (:1290-1293)
  * inflow/outflow sponge layers with quadratic ramps (:1295-1344), inflow
    ramped by gain=clamp(t/0.02,0,1) (:1682-1683)
  * non-finite/negative cell repair by reset-to-inflow (:1284-1289)
  * τ clock: t*=e^dτ, dt=t·dτ, then dτ feedback 0.8x/1.1x against dt_CFL,
    clamped to [1e-7, 5e-2] (:1680-1704)

Design notes:
  * The CUDA kernel computes BOTH faces of every cell, so each interior face
    flux is evaluated twice (identical values except at solid-degraded
    faces).  Here interior face fluxes are computed ONCE on (…, n+1) face
    arrays; only the wall-mirror case (which genuinely differs per side) is
    applied as a per-cell override — same results, half the WENO/HLLC work.
  * The reference's single-pass atomicMax wavespeed (:523-532, 1345-1351)
    becomes a masked jnp.max fused into the same step.
  * Everything (step + τ feedback) is one jit region scanning on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.clock import dtau_feedback
from ..core.config import BaseConfig
from ..ops.limiters import minmod
from ..ops.weno import weno5_lr_slab

__all__ = [
    "Hypersonic3DConfig",
    "Hypersonic3DState",
    "PrimT",
    "init",
    "step",
    "run",
    "vis_field",
    "VIS_MODES",
]

RHO_P_FLOOR = 1e-30
THERMAL_ENERGY_FLOOR = 1e-12
DENOM_EPS = 1e-12
NEWTON_TEMP_FLOOR = 1e-6
TAU_VIB_MIN = 1e-9
HALO = 3  # WENO5 stencil reach


@dataclass(frozen=True)
class Hypersonic3DConfig(BaseConfig):
    nx: int = 64
    ny: int = 64
    nz: int = 64
    dx: float = 1.0 / 64
    dy: float = 1.0 / 64
    dz: float = 1.0 / 64
    cfl: float = 0.3333
    u_ref: float = 10.0
    R: float = 10.0
    gamma_floor: float = 1.1
    Twall: float = 0.02
    tau_vib: float = 2e-4
    theta_v: float = 0.2
    sdf_cx: float = 0.5
    sdf_cy: float = 0.5
    sdf_cz: float = 0.5
    sdf_r: float = 0.25
    inflow_r: float = 0.02
    inflow_p: float = 0.02
    inflow_u: float = 100.0
    inflow_v: float = 0.0
    inflow_w: float = 0.0
    sponge_n: int = 24
    sponge_strength: float = 0.05
    sponge_out_n: int = 24
    sponge_out_strength: float = 0.05
    t0: float = 1e-5
    dtau0: float = 1e-3
    outflow: str = "transmissive"   # or "characteristic" (LODI-gated)
    dtype: str = "float32"

    def validate(self):
        self._require(self.outflow in ("transmissive", "characteristic"),
                      "outflow must be transmissive or characteristic")
        self._require(self.nx > 0 and self.ny > 0 and self.nz > 0,
                      "grid dims must be positive")
        self._require(self.gamma_floor > 1.0, "gamma must be > 1")
        self._require(self.cfl > 0.0, "cfl must be > 0")
        self._require(self.u_ref > 0.0, "u_ref must be > 0")
        self._require(self.R > 0.0, "R must be > 0")
        self._require(self.sdf_r > 0.0, "sdf_r must be > 0")


def default_config(n: int = 64, **kw) -> Hypersonic3DConfig:
    base = dict(nx=n, ny=n, nz=n, dx=1.0 / n, dy=1.0 / n, dz=1.0 / n)
    base.update(kw)
    return Hypersonic3DConfig(**base)


class PrimT(NamedTuple):
    """Primitive fields (density, velocities, pressure, vibrational energy).
    T and T_v are derived on demand."""

    r: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    p: jnp.ndarray
    ev: jnp.ndarray


class ConsT(NamedTuple):
    r: jnp.ndarray
    mx: jnp.ndarray
    my: jnp.ndarray
    mz: jnp.ndarray
    Et: jnp.ndarray
    Ev: jnp.ndarray


class Hypersonic3DState(NamedTuple):
    xi: jnp.ndarray    # ln rho, (nz, ny, nx)
    phix: jnp.ndarray  # asinh(u/u_ref)
    phiy: jnp.ndarray
    phiz: jnp.ndarray
    lam: jnp.ndarray   # ln p
    zet: jnp.ndarray   # ln e_vib
    solid: jnp.ndarray  # bool
    t: jnp.ndarray
    dtau: jnp.ndarray


# ------------------------- EOS / thermodynamics ----------------------------


def _tv_newton(cfg, evib, Tseed):
    """3-iteration Newton solve for T_v from e_vib
    (Tv_from_evib_seed, :191-204)."""
    Tv = jnp.maximum(cfg.Twall, jnp.maximum(Tseed, NEWTON_TEMP_FLOOR))
    for _ in range(3):
        a = cfg.theta_v / jnp.maximum(Tv, NEWTON_TEMP_FLOOR)
        ea = jnp.exp(a)
        denom = jnp.maximum(ea - 1.0, NEWTON_TEMP_FLOOR)
        f = (cfg.R * cfg.theta_v) / denom - evib
        df = (cfg.R * cfg.theta_v) * (ea * (cfg.theta_v / (Tv * Tv))) / (
            denom * denom
        )
        Tv = jnp.maximum(NEWTON_TEMP_FLOOR, Tv - f / jnp.maximum(df, DENOM_EPS))
    return Tv


def evib_eq(cfg, T):
    """Equilibrium vibrational energy at temperature T (:206-211)."""
    a = cfg.theta_v / jnp.maximum(T, NEWTON_TEMP_FLOOR)
    denom = jnp.maximum(jnp.exp(a) - 1.0, NEWTON_TEMP_FLOOR)
    return (cfg.R * cfg.theta_v) / denom


def tv_from_evib(cfg, evib, T):
    return _tv_newton(cfg, evib, T)


def _temp(cfg, q: PrimT):
    return q.p / (q.r * cfg.R)


def prim_to_cons(cfg, q: PrimT) -> ConsT:
    ke = 0.5 * (q.u * q.u + q.v * q.v + q.w * q.w)
    e_th = q.p / jnp.maximum((cfg.gamma_floor - 1.0) * q.r, RHO_P_FLOOR)
    return ConsT(
        r=q.r, mx=q.r * q.u, my=q.r * q.v, mz=q.r * q.w,
        Ev=q.r * q.ev, Et=q.r * (ke + e_th + q.ev),
    )


def cons_to_prim(cfg, U: ConsT) -> PrimT:
    r = jnp.maximum(U.r, RHO_P_FLOOR)
    u = U.mx / r
    v = U.my / r
    w = U.mz / r
    ke = 0.5 * (u * u + v * v + w * w)
    ev = jnp.maximum(U.Ev / r, 0.0)
    e_th = jnp.maximum(U.Et / r - ke - ev, THERMAL_ENERGY_FLOOR)
    p = jnp.maximum((cfg.gamma_floor - 1.0) * r * e_th, RHO_P_FLOOR)
    return PrimT(r=r, u=u, v=v, w=w, p=p, ev=ev)


def soundspeed(cfg, q: PrimT):
    return jnp.sqrt(jnp.maximum(cfg.gamma_floor * q.p / q.r, DENOM_EPS))


def axis_flux(cfg, q: PrimT, axis: int) -> ConsT:
    un = (q.u, q.v, q.w)[axis]
    H = (q.p / q.r) + (0.5 * (q.u * q.u + q.v * q.v + q.w * q.w) + q.ev) \
        + q.p / jnp.maximum((cfg.gamma_floor - 1.0) * q.r, RHO_P_FLOOR)
    mom = [q.r * q.u * un, q.r * q.v * un, q.r * q.w * un]
    mom[axis] = mom[axis] + q.p
    return ConsT(r=q.r * un, mx=mom[0], my=mom[1], mz=mom[2],
                 Et=q.r * H * un, Ev=q.r * q.ev * un)


# --------------------------- Riemann solver --------------------------------


def _signed_denom(x):
    return jnp.where(x >= 0.0, jnp.maximum(jnp.abs(x), DENOM_EPS),
                     -jnp.maximum(jnp.abs(x), DENOM_EPS))


def _entropy_fix(s, a_ref):
    """Harten entropy fix on wave speed estimates (:366-374)."""
    d = 0.1 * a_ref
    as_ = jnp.abs(s)
    sm = 0.5 * (as_ * as_ / jnp.maximum(d, DENOM_EPS) + d)
    sgn = jnp.where(s >= 0.0, 1.0, -1.0)
    return jnp.where(as_ >= d, s, sgn * sm)


def _shock_sensor(L: PrimT, R: PrimT):
    dp = jnp.abs(R.p - L.p) / jnp.maximum(R.p + L.p, DENOM_EPS)
    dr = jnp.abs(R.r - L.r) / jnp.maximum(R.r + L.r, DENOM_EPS)
    return jnp.clip(5.0 * 0.5 * (dp + dr), 0.0, 1.0)


def _crossflow_speed(L: PrimT, R: PrimT, axis: int):
    comps = [(L.u, R.u), (L.v, R.v), (L.w, R.w)]
    del comps[axis]
    total = sum(jnp.abs(a) + jnp.abs(b) for a, b in comps)
    return total * 0.5


def _cmap(f, *cs):
    return ConsT(*(f(*vals) for vals in zip(*cs)))


def hllc_flux(cfg, L: PrimT, R: PrimT, axis: int) -> ConsT:
    """HLLC with entropy fix and shock-sensor HLL blending (:383-460)."""
    aL = soundspeed(cfg, L)
    aR = soundspeed(cfg, R)
    unL = (L.u, L.v, L.w)[axis]
    unR = (R.u, R.v, R.w)[axis]
    sL = jnp.minimum(unL - aL, unR - aR)
    sR = jnp.maximum(unL + aL, unR + aR)
    aRef = jnp.maximum(aL, aR)
    sL = _entropy_fix(sL, aRef)
    sR = _entropy_fix(sR, aRef)

    UL = prim_to_cons(cfg, L)
    UR = prim_to_cons(cfg, R)
    FL = axis_flux(cfg, L, axis)
    FR = axis_flux(cfg, R, axis)

    denom = _signed_denom(L.r * (sL - unL) - R.r * (sR - unR))
    sM = (R.p - L.p + L.r * unL * (sL - unL) - R.r * unR * (sR - unR)) / denom

    pStar = 0.5 * (
        (L.p + L.r * (sL - unL) * (sM - unL))
        + (R.p + R.r * (sR - unR) * (sM - unR))
    )

    align = jnp.clip(
        1.0 - _crossflow_speed(L, R, axis) / jnp.maximum(aRef, DENOM_EPS),
        0.0, 1.0,
    )
    alpha = _shock_sensor(L, R) * align

    invSRL = 1.0 / _signed_denom(sR - sL)
    FHLL = _cmap(
        lambda fl, fr, ul, ur: (sR * fl - sL * fr + sL * sR * (ur - ul)) * invSRL,
        FL, FR, UL, UR,
    )

    def star_side(qS, US, FS, sS, unS):
        d = _signed_denom(sS - sM)
        rStar = qS.r * (sS - unS) / d
        EStar = ((sS - unS) * US.Et - qS.p * unS + pStar * sM) / d
        EvStar = US.Ev * (sS - unS) / d
        mom = [rStar * qS.u, rStar * qS.v, rStar * qS.w]
        mom[axis] = rStar * sM
        UStar = ConsT(r=rStar, mx=mom[0], my=mom[1], mz=mom[2],
                      Et=EStar, Ev=EvStar)
        return _cmap(lambda f, us, u: f + sS * (us - u), FS, UStar, US)

    F_left = star_side(L, UL, FL, sL, unL)
    F_right = star_side(R, UR, FR, sR, unR)
    F_star = _cmap(lambda a, b: jnp.where(sM >= 0.0, a, b), F_left, F_right)
    blended = _cmap(lambda fs, fh: (1.0 - alpha) * fs + alpha * fh, F_star, FHLL)

    return _cmap(
        lambda fl, fr, bl: jnp.where(sL >= 0.0, fl, jnp.where(sR <= 0.0, fr, bl)),
        FL, FR, blended,
    )


def hllc_wall_flux(cfg, q: PrimT, axis: int, left: bool = True) -> ConsT:
    """hllc_flux(q, mirror(q)) if `left` else hllc_flux(mirror(q), q),
    specialized for the symmetric wall pair (the per-side mirrored
    Riemann problems of :1128-1131, 1148-1151).  For R = mirror(L):
    the Roe-free wave estimates collapse to sL = -(|un|+a), sR = +(|un|+a)
    (so the entropy fix is the identity — |s| >= a > 0.1*a always), the
    contact speed sM is EXACTLY zero (the numerator's two terms cancel
    bitwise), the shock sensor is exactly zero (dp = dr = 0, so the HLL
    blend vanishes), and the interface flux is the L-side star flux.
    One soundspeed/cons/flux evaluation instead of two plus no FHLL —
    ~1/3 the arithmetic of the generic path, bitwise-equal to it up to
    +-0 edge cases (tested)."""
    L = q if left else _mirror(q, axis)
    a = soundspeed(cfg, L)
    unL = (L.u, L.v, L.w)[axis]
    s = jnp.abs(unL) + a
    sL = -s
    UL = prim_to_cons(cfg, L)
    FL = axis_flux(cfg, L, axis)
    # (pStar enters the generic EStar only as pStar * sM == +-0: dropped)
    d = _signed_denom(sL)
    rStar = L.r * (sL - unL) / d
    EStar = ((sL - unL) * UL.Et - L.p * unL) / d
    EvStar = UL.Ev * (sL - unL) / d
    mom = [rStar * L.u, rStar * L.v, rStar * L.w]
    mom[axis] = jnp.zeros_like(rStar)     # rStar * sM with sM == 0
    UStar = ConsT(r=rStar, mx=mom[0], my=mom[1], mz=mom[2],
                  Et=EStar, Ev=EvStar)
    return _cmap(lambda f, us, u: f + sL * (us - u), FL, UStar, UL)


# --------------------------- state / geometry ------------------------------


def _pwall(cfg, q: PrimT) -> PrimT:
    """Isothermal no-slip wall ghost (apply_wall, :511-521)."""
    p_keep = jnp.maximum(q.p, RHO_P_FLOOR)
    r = jnp.maximum(
        p_keep / (cfg.R * max(cfg.Twall, NEWTON_TEMP_FLOOR)), RHO_P_FLOOR
    )
    z = jnp.zeros_like(q.u)
    ev = evib_eq(cfg, jnp.full_like(q.p, cfg.Twall))
    return PrimT(r=r, u=z, v=z, w=z, p=p_keep, ev=ev)


def evib_eq_py(cfg, T: float) -> float:
    """Host-side evib_eq for static config-derived constants."""
    import math

    a = cfg.theta_v / max(T, NEWTON_TEMP_FLOOR)
    if a > 700.0:  # exp would overflow float64; e_vib^eq underflows to 0
        return 0.0
    denom = max(math.exp(a) - 1.0, NEWTON_TEMP_FLOOR)
    return (cfg.R * cfg.theta_v) / denom


def inflow_prim(cfg, dtype=None) -> PrimT:
    dt = dtype or jnp.dtype(cfg.dtype)
    r = max(cfg.inflow_r, RHO_P_FLOOR)
    p = max(cfg.inflow_p, RHO_P_FLOOR)
    T = p / (r * cfg.R)
    ev = evib_eq_py(cfg, T)
    mk = lambda v: jnp.asarray(v, dt)  # noqa: E731
    return PrimT(r=mk(r), u=mk(cfg.inflow_u), v=mk(cfg.inflow_v),
                 w=mk(cfg.inflow_w), p=mk(p), ev=mk(ev))


def build_solid(cfg, pad: int = 0) -> np.ndarray:
    """Sphere SDF rasterized at cell centers (k_build_solid_mask :759-770),
    optionally evaluated on a halo-extended grid (cell_is_solid extends the
    SDF beyond the domain, :180-189)."""
    x = (np.arange(-pad, cfg.nx + pad) + 0.5) * cfg.dx
    y = (np.arange(-pad, cfg.ny + pad) + 0.5) * cfg.dy
    z = (np.arange(-pad, cfg.nz + pad) + 0.5) * cfg.dz
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    d = np.sqrt(
        (X - cfg.sdf_cx) ** 2 + (Y - cfg.sdf_cy) ** 2 + (Z - cfg.sdf_cz) ** 2
    ) - cfg.sdf_r
    return d < 0.0


def _encode(cfg, q: PrimT):
    xi = jnp.log(jnp.maximum(q.r, RHO_P_FLOOR))
    phix = jnp.arcsinh(q.u / cfg.u_ref)
    phiy = jnp.arcsinh(q.v / cfg.u_ref)
    phiz = jnp.arcsinh(q.w / cfg.u_ref)
    lam = jnp.log(jnp.maximum(q.p, RHO_P_FLOOR))
    zet = jnp.log(jnp.maximum(q.ev, RHO_P_FLOOR))
    return xi, phix, phiy, phiz, lam, zet


def _decode(cfg, xi, phix, phiy, phiz, lam, zet) -> PrimT:
    return PrimT(
        r=jnp.exp(xi),
        u=cfg.u_ref * jnp.sinh(phix),
        v=cfg.u_ref * jnp.sinh(phiy),
        w=cfg.u_ref * jnp.sinh(phiz),
        p=jnp.exp(lam),
        ev=jnp.exp(zet),
    )


def init(cfg: Hypersonic3DConfig) -> Hypersonic3DState:
    """Quiescent inflow-density gas; solid cells hold the wall state
    (k_init, :939-985)."""
    dt = cfg.jax_dtype
    shape = (cfg.nz, cfg.ny, cfg.nx)
    solid = jnp.asarray(build_solid(cfg))

    r = max(cfg.inflow_r, RHO_P_FLOOR)
    p = max(cfg.inflow_p, RHO_P_FLOOR)
    T = p / (r * cfg.R)
    ev_f = evib_eq_py(cfg, T)

    # wall cells: T=Twall, same p, rho from ideal gas, ev at wall temp
    rw = max(p / (cfg.R * max(cfg.Twall, NEWTON_TEMP_FLOOR)), RHO_P_FLOOR)
    evw = evib_eq_py(cfg, cfg.Twall)

    full = lambda v: jnp.full(shape, v, dt)  # noqa: E731
    q = PrimT(
        r=jnp.where(solid, full(rw), full(r)),
        u=full(0.0), v=full(0.0), w=full(0.0),
        p=full(p),
        ev=jnp.where(solid, full(evw), full(ev_f)),
    )
    xi, phix, phiy, phiz, lam, zet = _encode(cfg, q)
    return Hypersonic3DState(
        xi=xi, phix=phix, phiy=phiy, phiz=phiz, lam=lam, zet=zet,
        solid=solid,
        t=jnp.asarray(cfg.t0, dt), dtau=jnp.asarray(cfg.dtau0, dt),
    )


# ------------------------------- stepping ----------------------------------


def _pad_field(cfg, f, outflow_col):
    """Halo-3 padding: x- side = will be overwritten by inflow/wall selects
    (uses edge for now), x+ side = outflow ghost column(s), y/z periodic
    wrap.  `outflow_col` is (nz, ny) — one column repeated HALO times
    (transmissive) — or (nz, ny, HALO) with per-ghost values
    (characteristic)."""
    # x: left pad handled by caller (inflow constant), right by outflow ghost
    left = jnp.repeat(f[:, :, :1], HALO, axis=2) * 0  # placeholder, replaced
    if outflow_col.ndim == 2:
        right = jnp.repeat(outflow_col[:, :, None], HALO, axis=2)
    else:
        right = outflow_col
    f = jnp.concatenate([left, f, right], axis=2)
    # y periodic
    f = jnp.concatenate([f[:, -HALO:, :], f, f[:, :HALO, :]], axis=1)
    # z periodic
    f = jnp.concatenate([f[-HALO:, :, :], f, f[:HALO, :, :]], axis=0)
    return f


def _outflow_transmissive(cfg, q: PrimT, infl):
    """Transmissive outflow ghost with subsonic pressure relaxation and
    reversed-flow inflow snap (outflow_prim_transmissive, :691-722).
    Returns one (nz, ny) column per component."""
    qR = PrimT(*(f[:, :, -1] for f in q))
    aR = soundspeed(cfg, qR)
    un = qR.u
    p_amb = max(cfg.inflow_p, RHO_P_FLOOR)
    relax_p = jnp.maximum(qR.p + 0.05 * (p_amb - qR.p), RHO_P_FLOOR)
    p_out = jnp.where(un < aR, relax_p, qR.p)
    q_out = PrimT(
        r=jnp.maximum(qR.r, RHO_P_FLOOR), u=qR.u, v=qR.v, w=qR.w,
        p=jnp.maximum(p_out, RHO_P_FLOOR), ev=jnp.maximum(qR.ev, 0.0),
    )
    # reversed flow at the outlet snaps to inflow (:705-708)
    return PrimT(*(
        jnp.where(un < 0.0, jnp.broadcast_to(i, o.shape), o)
        for i, o in zip(infl, q_out)
    ))


def _outflow_characteristic(cfg, q: PrimT, infl):
    """LODI characteristic outflow ghosts (outflow_prim_characteristic,
    :624-690): linear extrapolation from the last two columns decomposed
    into waves against the inflow target, with outgoing-only gating on
    sign(un -/+ a) and sign(un).  Returns (nz, ny, HALO) per component —
    ghost g uses the g-fold extrapolation, matching xghost - (nx-1)."""
    qR = PrimT(*(f[:, :, -1] for f in q))
    qL = PrimT(*(f[:, :, -2] for f in q)) if cfg.nx > 1 else qR
    a = soundspeed(cfg, qR)
    a2 = a * a
    rho_ref = jnp.maximum(qR.r, RHO_P_FLOOR)
    un = qR.u
    qT = infl

    cols = []
    for g in range(1, HALO + 1):
        gf = float(g)
        ex = PrimT(
            r=jnp.maximum(qR.r + gf * (qR.r - qL.r), RHO_P_FLOOR),
            u=qR.u + gf * (qR.u - qL.u),
            v=qR.v + gf * (qR.v - qL.v),
            w=qR.w + gf * (qR.w - qL.w),
            p=jnp.maximum(qR.p + gf * (qR.p - qL.p), RHO_P_FLOOR),
            ev=jnp.maximum(qR.ev + gf * (qR.ev - qL.ev), 0.0),
        )
        drho, du, dp = ex.r - qT.r, ex.u - qT.u, ex.p - qT.p
        L1 = 0.5 * (dp / a2 - rho_ref * du / a)
        L5 = 0.5 * (dp / a2 + rho_ref * du / a)
        L2 = drho - dp / a2
        L3, L4, L6 = ex.v - qT.v, ex.w - qT.w, ex.ev - qT.ev
        L1 = jnp.where(un - a < 0.0, 0.0, L1)
        incoming = un < 0.0
        L2 = jnp.where(incoming, 0.0, L2)
        L3 = jnp.where(incoming, 0.0, L3)
        L4 = jnp.where(incoming, 0.0, L4)
        L6 = jnp.where(incoming, 0.0, L6)
        L5 = jnp.where(un + a < 0.0, 0.0, L5)
        cols.append(PrimT(
            r=jnp.maximum(qT.r + L1 + L2 + L5, RHO_P_FLOOR),
            u=qT.u + (L5 - L1) / jnp.maximum(rho_ref * a, DENOM_EPS),
            v=qT.v + L3,
            w=qT.w + L4,
            p=jnp.maximum(qT.p + a2 * (L1 + L5), RHO_P_FLOOR),
            ev=jnp.maximum(qT.ev + L6, 0.0),
        ))
    return PrimT(*(jnp.stack(fs, axis=-1)
                   for fs in zip(*cols)))


def _padded_prims(cfg, q: PrimT, solid_pad):
    """Build halo-extended primitive fields with all BCs resolved
    (prim_at_xbc semantics + apply_wall on solid cells, :724-751)."""
    infl = inflow_prim(cfg, q.r.dtype)

    if cfg.outflow == "characteristic":
        q_out = _outflow_characteristic(cfg, q, infl)
    else:
        q_out = _outflow_transmissive(cfg, q, infl)

    padded = []
    for comp, out_col, infl_val in zip(q, q_out, infl):
        p = _pad_field(cfg, comp, out_col)
        # left x pad = inflow constant
        p = p.at[:, :, :HALO].set(infl_val)
        padded.append(p)
    qp = PrimT(*padded)

    # wall substitution on (extended) solid cells
    wall = _pwall(cfg, qp)
    qp = PrimT(*(jnp.where(solid_pad, w, f) for w, f in zip(wall, qp)))
    return qp


def _sl(f, axis, lo, hi_off):
    """Static slice on the padded (nz+2H, ny+2H, nx+2H) array: the window
    starting at halo offset `lo` with domain extent (+hi_off) along `axis`,
    full domain extent on the other axes."""
    starts = [HALO, HALO, HALO]
    sizes = [f.shape[0] - 2 * HALO, f.shape[1] - 2 * HALO, f.shape[2] - 2 * HALO]
    starts[axis] = lo
    sizes[axis] = sizes[axis] + hi_off
    return f[tuple(slice(st, st + n) for st, n in zip(starts, sizes))]


def _face_prims(cfg, qp: PrimT, solid_pad, axis: int):
    """WENO5 (or first-order near solids) L/R states on every interior+boundary
    face along `axis`: face arrays have domain extent +1 along `axis`.

    Face k sits between padded cells k+H-1 and k+H (k in [0, n]).
    """
    # arrays are (z, y, x); map spatial axis (0=x,1=y,2=z) to array axis
    arr_ax = {0: 2, 1: 1, 2: 0}[axis]

    def shifted(off):
        # value of padded cell (face_index + H - 1 + off) => slice start
        return PrimT(*(_sl(f, arr_ax, HALO - 1 + off, 1) for f in qp))

    q_0 = shifted(0)     # left cell of the face
    q_p1 = shifted(1)    # right cell of the face

    # both reconstructions in one pass with the smoothness indicators,
    # their reciprocal squares, and two of three candidate polynomials
    # shared across faces AND sides (ops/weno.weno5_lr_slab)
    def crop_other(f):
        sl = [slice(HALO, f.shape[d] - HALO) for d in range(3)]
        sl[arr_ax] = slice(None)
        return f[tuple(sl)]

    lr = [weno5_lr_slab(crop_other(f), arr_ax, HALO) for f in qp]
    L = PrimT(*(x[0] for x in lr))
    R = PrimT(*(x[1] for x in lr))

    def floor_prim(q):
        return PrimT(
            r=jnp.maximum(q.r, RHO_P_FLOOR), u=q.u, v=q.v, w=q.w,
            p=jnp.maximum(q.p, RHO_P_FLOOR), ev=jnp.maximum(q.ev, 0.0),
        )

    L = floor_prim(L)
    R = floor_prim(R)

    # stencil degradation: any solid in the 6-cell line -> first-order pair
    # (q_0, q_p1) (:1132-1138,1152-1158)
    s_any = None
    for off in (-2, -1, 0, 1, 2, 3):
        s = _sl(solid_pad, arr_ax, HALO - 1 + off, 1)
        s_any = s if s_any is None else (s_any | s)
    L = PrimT(*(jnp.where(s_any, a, b) for a, b in zip(floor_prim(q_0), L)))
    R = PrimT(*(jnp.where(s_any, a, b) for a, b in zip(floor_prim(q_p1), R)))
    return L, R, q_0, q_p1


def solid_box_from_mask(solid_pad) -> tuple | None:
    """Static inclusive bounds ((zlo,zhi),(ylo,yhi),(xlo,xhi)) of the solid
    in PADDED coordinates, from a concrete (numpy) halo-extended mask.
    Returns None when no cell is solid.  Trace-time helper: the geometry
    is config-derived and static, so the wall-mirror fluxes only need
    computing on this box (everywhere else face_solid is false and the
    flux select never reads them — restriction is bitwise-free)."""
    import numpy as _np

    m = _np.asarray(solid_pad)
    if not m.any():
        return None
    out = []
    for d in range(3):
        ax = tuple(i for i in range(3) if i != d)
        hit = _np.nonzero(m.any(axis=ax))[0]
        out.append((int(hit[0]), int(hit[-1])))
    return tuple(out)


def _boxed_wall_flux(cfg, qface: PrimT, spatial_axis: int, left: bool,
                     solid_box) -> ConsT:
    """hllc_wall_flux computed only on the static face sub-box that can
    touch a solid cell (zeros elsewhere).  `solid_box` is
    solid_box_from_mask output (padded coords); entries may extend past
    the window (they are clamped), so a z-banded kernel window passes an
    unbounded z range.  Every wall-flux value the downstream
    `where(face_solid, ...)` can select is bitwise the dense call's —
    face_solid is false outside the box by construction."""
    arr_ax = {0: 2, 1: 1, 2: 0}[spatial_axis]
    shape = qface.r.shape
    zeros = lambda: ConsT(*(jnp.zeros(shape, qface.r.dtype)  # noqa: E731
                            for _ in range(6)))
    if solid_box is None:
        return zeros()
    slices = []
    for d in range(3):
        lo, hi = solid_box[d]
        if d == arr_ax:
            # face k reads padded cells k+H-1 and k+H -> solid faces span
            # k in [lo-H, hi-H+1]
            a, b = lo - HALO, hi - HALO + 2
        else:
            # face arrays index interior cells (padded j+H)
            a, b = lo - HALO, hi - HALO + 1
        a, b = max(a, 0), min(b, shape[d])
        if a >= b:
            return zeros()
        slices.append((a, b))
    sub = PrimT(*(f[tuple(slice(a, b) for a, b in slices)] for f in qface))
    Fs = hllc_wall_flux(cfg, sub, spatial_axis, left=left)
    pad = tuple((slices[d][0], shape[d] - slices[d][1]) for d in range(3))
    return ConsT(*(jnp.pad(f, pad) for f in Fs))


def _mirror(q: PrimT, axis: int) -> PrimT:
    comps = {"u": q.u, "v": q.v, "w": q.w}
    key = ("u", "v", "w")[axis]
    comps[key] = -comps[key]
    return PrimT(r=q.r, u=comps["u"], v=comps["v"], w=comps["w"], p=q.p,
                 ev=q.ev)


def step_core_padded(cfg: Hypersonic3DConfig, qp: PrimT, solid_pad,
                     dt, inflow_gain, solid_box="dense") -> PrimT:
    """The full cell update on a halo-extended window of BC-resolved
    primitives: WENO faces -> HLLC with wall mirroring -> conservative
    update -> repair -> Landau-Teller -> sponges.  Window-agnostic along
    z and y (the z-slab sharded runner calls it on extended slabs); x is
    always the whole domain, since the sponge ramps are functions of
    global x.

    `solid_box`: "dense" computes the wall-mirror fluxes at every face
    (always correct); a solid_box_from_mask value (or None for no solid)
    restricts them to the static sub-box that can touch the solid.  The
    selected wall-flux values are bitwise those of the dense path (the
    flux select reads wall values only where face_solid is true, inside
    the box by construction; tested in test_hypersonic3d.py); the
    step-level output can still differ at the 1-2 ulp level because the
    two graphs lower to different XLA fusions (FMA contraction), the
    same noise class the sharded equivalence gates already allow."""
    dtype = qp.r.dtype

    q0_cell = PrimT(*(f[HALO:-HALO, HALO:-HALO, HALO:-HALO] for f in qp))

    fluxes = []
    for axis in range(3):
        arr_ax = {0: 2, 1: 1, 2: 0}[axis]
        L, R, qface_l, qface_r = _face_prims(cfg, qp, solid_pad, axis)
        F = hllc_flux(cfg, L, R, axis)

        # wall-mirror override where the face touches a solid cell
        # (:1128-1131, 1148-1151). This is per-SIDE: the cell left of the
        # face uses (q_left, mirror(q_left)); the right cell uses
        # (mirror(q_right), q_right).
        sl = _sl(solid_pad, arr_ax, HALO - 1, 1)
        sr = _sl(solid_pad, arr_ax, HALO, 1)
        face_solid = sl | sr

        # specialized symmetric-pair HLLC: bitwise-equal to the generic
        # hllc_flux on (q, mirror(q)) at ~1/3 the arithmetic (tested)
        if solid_box == "dense":
            F_from_left = hllc_wall_flux(cfg, qface_l, axis, left=True)
            F_from_right = hllc_wall_flux(cfg, qface_r, axis, left=False)
        else:
            F_from_left = _boxed_wall_flux(cfg, qface_l, axis, True,
                                           solid_box)
            F_from_right = _boxed_wall_flux(cfg, qface_r, axis, False,
                                            solid_box)

        fluxes.append((F, face_solid, F_from_left, F_from_right, arr_ax))

    U0 = prim_to_cons(cfg, q0_cell)

    inv_d = (1.0 / cfg.dx, 1.0 / cfg.dy, 1.0 / cfg.dz)
    dU = None
    for axis in range(3):
        F, face_solid, F_wl, F_wr, arr_ax = fluxes[axis]
        n = F.r.shape[arr_ax]

        def lo(f):
            return jax.lax.slice_in_dim(f, 0, n - 1, axis=arr_ax)

        def hi(f):
            return jax.lax.slice_in_dim(f, 1, n, axis=arr_ax)

        # minus-face flux of each cell: face k; wall override -> mirrored
        # Riemann problem seen from this (right-of-face) cell.
        Fm = ConsT(*(
            jnp.where(lo(face_solid), lo(w), lo(f)) for f, w in zip(F, F_wr)
        ))
        # plus-face flux: face k+1; wall override from this (left) cell.
        Fp = ConsT(*(
            jnp.where(hi(face_solid), hi(w), hi(f)) for f, w in zip(F, F_wl)
        ))
        contrib = ConsT(*(-(p - m) * inv_d[axis] for p, m in zip(Fp, Fm)))
        dU = contrib if dU is None else ConsT(*(a + b for a, b in zip(dU, contrib)))

    U1 = ConsT(*(u + dt * d for u, d in zip(U0, dU)))
    q1 = cons_to_prim(cfg, U1)

    # non-finite / non-physical repair -> inflow (:1284-1289)
    bad = jnp.zeros_like(q1.r, bool)
    for f in q1:
        bad |= ~jnp.isfinite(f)
    bad |= (q1.r <= 0.0) | (q1.p <= 0.0) | (q1.ev < 0.0)
    infl = inflow_prim(cfg, dtype)
    q1 = PrimT(*(
        jnp.where(bad, jnp.broadcast_to(i, f.shape), f) for i, f in zip(infl, q1)
    ))

    # Landau–Teller relaxation (:1290-1293)
    T1 = _temp(cfg, q1)
    ev_eq = evib_eq(cfg, T1)
    relax = dt / max(cfg.tau_vib, TAU_VIB_MIN)
    q1 = q1._replace(ev=jnp.maximum(q1.ev + (ev_eq - q1.ev) * relax, 0.0))

    # sponge layers (:1295-1344).  Each sponge transforms only its static x-column slab: inside the
    # slab the math is the dense form on a slice (bitwise-equal); outside,
    # the dense form was a provable identity (ramp k == 0.0 exactly and
    # post-repair fields satisfy the floors), so skipping it changes
    # nothing but the arithmetic (it no longer rewrites -0.0 velocity
    # signs to +0.0, which no downstream consumer distinguishes).
    def sponge_slab(q, g_lo, g_hi, fn):
        """Apply fn(sub, col_lo) to window columns covering global x in
        [g_lo, g_hi); col_lo is the slice's window-column offset."""
        wx = q.r.shape[2]
        col_lo, col_hi = max(g_lo, 0), min(g_hi, wx)
        if col_lo >= col_hi:
            return q
        sub = PrimT(*(f[:, :, col_lo:col_hi] for f in q))
        sub = fn(sub, col_lo)

        def stitch(f, g):
            # emit only the non-empty segments
            parts = ([f[:, :, :col_lo]] if col_lo > 0 else []) + [g] + \
                ([f[:, :, col_hi:]] if col_hi < wx else [])
            return parts[0] if len(parts) == 1 else \
                jnp.concatenate(parts, axis=2)

        return PrimT(*(stitch(f, g) for f, g in zip(q, sub)))

    def xs_of(sub, col_lo):
        return jax.lax.broadcasted_iota(
            jnp.int32, (1, 1, sub.r.shape[2]), 2).astype(dtype) + col_lo

    tgtT = max(cfg.inflow_p, RHO_P_FLOOR) / (
        max(cfg.inflow_r, RHO_P_FLOOR) * cfg.R
    )
    if cfg.sponge_n > 0:
        def sponge_in(sub, col_lo):
            sramp = jnp.clip(1.0 - xs_of(sub, col_lo) / cfg.sponge_n,
                             0.0, 1.0)
            k_in = cfg.sponge_strength * sramp**2
            tgt_u = inflow_gain * cfg.inflow_u
            tgt_v = inflow_gain * cfg.inflow_v
            tgt_w = inflow_gain * cfg.inflow_w
            tgt_ev = evib_eq_py(cfg, tgtT)
            return PrimT(
                r=jnp.maximum(
                    sub.r + k_in * (max(cfg.inflow_r, RHO_P_FLOOR) - sub.r),
                    RHO_P_FLOOR),
                u=sub.u + k_in * (tgt_u - sub.u),
                v=sub.v + k_in * (tgt_v - sub.v),
                w=sub.w + k_in * (tgt_w - sub.w),
                p=jnp.maximum(
                    sub.p + k_in * (max(cfg.inflow_p, RHO_P_FLOOR) - sub.p),
                    RHO_P_FLOOR),
                ev=jnp.maximum(sub.ev + k_in * (tgt_ev - sub.ev), 0.0),
            )

        q1 = sponge_slab(q1, 0, cfg.sponge_n, sponge_in)
    if cfg.sponge_out_n > 0:
        def sponge_out(sub, col_lo):
            xo = xs_of(sub, col_lo) - (cfg.nx - cfg.sponge_out_n)
            oramp = jnp.clip(xo / cfg.sponge_out_n, 0.0, 1.0) * (xo >= 0)
            k_out = cfg.sponge_out_strength * oramp**2
            tgt_ev = evib_eq_py(cfg, tgtT)
            return PrimT(
                r=jnp.maximum(
                    sub.r + k_out * (max(cfg.inflow_r, RHO_P_FLOOR) - sub.r),
                    RHO_P_FLOOR),
                u=sub.u + k_out * (0.0 - sub.u),
                v=sub.v + k_out * (0.0 - sub.v),
                w=sub.w + k_out * (0.0 - sub.w),
                p=jnp.maximum(
                    sub.p + k_out * (max(cfg.inflow_p, RHO_P_FLOOR) - sub.p),
                    RHO_P_FLOOR),
                ev=jnp.maximum(sub.ev + k_out * (tgt_ev - sub.ev), 0.0),
            )

        q1 = sponge_slab(q1, cfg.nx - cfg.sponge_out_n, cfg.nx, sponge_out)

    return q1


def step(cfg: Hypersonic3DConfig, s: Hypersonic3DState,
         solid_pad=None, wavespeed_reduce=None,
         gain_mul=None) -> Hypersonic3DState:
    """One fused step. `solid_pad` (halo-3 extended solid mask) and
    `wavespeed_reduce` (cross-device lax.pmax) are hooks for the sharded
    multi-chip path (parallel/hypersonic3d_sharded.py).  `gain_mul`
    multiplies the inflow ramp (the interactive a_gain nudge,
    tau_hypersonic_3d_cuda.cu:1658-1661) and may be a traced scalar so
    nudging it does not recompile."""
    dtype = s.xi.dtype
    solid = s.solid
    solid_box = "dense"  # traced masks (sharded slabs) stay dense
    if solid_pad is None:
        mask = build_solid(cfg, pad=HALO)
        solid_box = solid_box_from_mask(mask)  # static geometry
        solid_pad = jnp.asarray(mask)

    # τ advance (pre-step, :1680-1683)
    t = s.t * jnp.exp(s.dtau)
    dt = t * s.dtau
    inflow_gain = jnp.clip(t / 0.02, 0.0, 1.0)
    if gain_mul is not None:
        inflow_gain = inflow_gain * gain_mul

    q = _decode(cfg, s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
    qp = _padded_prims(cfg, q, solid_pad)

    q1 = step_core_padded(cfg, qp, solid_pad, dt, inflow_gain,
                          solid_box=solid_box)

    # max wavespeed over fluid cells (atomicMaxFloat analog, :1345-1351)
    a1 = soundspeed(cfg, q1)
    ssum = (jnp.abs(q1.u) + a1) / cfg.dx + (jnp.abs(q1.v) + a1) / cfg.dy \
        + (jnp.abs(q1.w) + a1) / cfg.dz
    ssum = jnp.where(jnp.isfinite(ssum) & ~solid, ssum, 0.0)
    maxs = jnp.max(ssum)
    if wavespeed_reduce is not None:
        maxs = wavespeed_reduce(maxs)

    # dτ feedback controller (:1697-1704), shared deadband helper
    dt_cfl = cfg.cfl / jnp.maximum(maxs, 1e-9)
    dtau = dtau_feedback(s.dtau, dt, dt_cfl)

    xi2, phix2, phiy2, phiz2, lam2, zet2 = _encode(cfg, q1)

    # solid cells keep their previous state (:1063-1072)
    keep = lambda new, old: jnp.where(solid, old, new)  # noqa: E731
    return Hypersonic3DState(
        xi=keep(xi2, s.xi), phix=keep(phix2, s.phix), phiy=keep(phiy2, s.phiy),
        phiz=keep(phiz2, s.phiz), lam=keep(lam2, s.lam), zet=keep(zet2, s.zet),
        solid=solid, t=t, dtau=dtau,
    )


def run(cfg: Hypersonic3DConfig, s: Hypersonic3DState, n_steps: int,
        gain_mul=None):
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st, gain_mul=gain_mul), s,
                      n_steps)


# ------------------------------ view modes ---------------------------------

def outflow_reflection_metric(cfg, s: Hypersonic3DState, nprobe: int = 6):
    """Outflow-reflection diagnostic: max |p - p_inflow| over the last
    `nprobe` x-columns (k_outflow_reflection_metric,
    tau_hypersonic_3d_cuda.cu:1389-1410; the atomicMaxFloat reduction
    becomes a jnp.max)."""
    nprobe = max(1, min(int(nprobe), cfg.nx))
    p = jnp.exp(s.lam[:, :, -nprobe:])
    p_ref = max(cfg.inflow_p, RHO_P_FLOOR)
    return jnp.max(jnp.abs(p - p_ref))


VIS_MODES = [
    "schlieren", "log_rho", "log_p", "speed", "mach", "vorticity",
    "divergence", "q_criterion",
]


def vis_field(cfg, s: Hypersonic3DState, mode: str):
    """Diagnostic scalar volume (k_vis, :800-905); zero inside solids."""
    q = _decode(cfg, s.xi, s.phix, s.phiy, s.phiz, s.lam, s.zet)
    solid_pad = jnp.asarray(build_solid(cfg, pad=HALO))
    qp = _padded_prims(cfg, q, solid_pad)
    qc = PrimT(*(f[HALO:-HALO, HALO:-HALO, HALO:-HALO] for f in qp))

    if mode == "log_rho":
        out = jnp.log1p(jnp.maximum(qc.r, 0.0))
    elif mode == "log_p":
        out = jnp.log1p(jnp.maximum(qc.p, 0.0))
    elif mode == "speed":
        out = jnp.sqrt(qc.u**2 + qc.v**2 + qc.w**2)
    elif mode == "mach":
        out = jnp.sqrt(qc.u**2 + qc.v**2 + qc.w**2) / jnp.maximum(
            soundspeed(cfg, qc), DENOM_EPS
        )
    else:
        def nb(axis, off):
            arr_ax = {0: 2, 1: 1, 2: 0}[axis]
            return PrimT(*(_sl(f, arr_ax, HALO + off, 0) for f in qp))

        qxm, qxp = nb(0, -1), nb(0, 1)
        qym, qyp = nb(1, -1), nb(1, 1)
        qzm, qzp = nb(2, -1), nb(2, 1)
        i2x, i2y, i2z = 0.5 / cfg.dx, 0.5 / cfg.dy, 0.5 / cfg.dz

        if mode == "schlieren":
            gx = (qxp.r - qxm.r) * i2x
            gy = (qyp.r - qym.r) * i2y
            gz = (qzp.r - qzm.r) * i2z
            out = jnp.sqrt(gx * gx + gy * gy + gz * gz)
        else:
            dudx, dudy, dudz = (qxp.u - qxm.u) * i2x, (qyp.u - qym.u) * i2y, \
                (qzp.u - qzm.u) * i2z
            dvdx, dvdy, dvdz = (qxp.v - qxm.v) * i2x, (qyp.v - qym.v) * i2y, \
                (qzp.v - qzm.v) * i2z
            dwdx, dwdy, dwdz = (qxp.w - qxm.w) * i2x, (qyp.w - qym.w) * i2y, \
                (qzp.w - qzm.w) * i2z
            if mode == "divergence":
                out = dudx + dvdy + dwdz
            elif mode == "vorticity":
                wx = dwdy - dvdz
                wy = dudz - dwdx
                wz = dvdx - dudy
                out = jnp.sqrt(wx * wx + wy * wy + wz * wz)
            elif mode == "q_criterion":
                O12 = 0.5 * (dudy - dvdx)
                O13 = 0.5 * (dudz - dwdx)
                O23 = 0.5 * (dvdz - dwdy)
                Om2 = 2.0 * (O12**2 + O13**2 + O23**2)
                S12 = 0.5 * (dudy + dvdx)
                S13 = 0.5 * (dudz + dwdx)
                S23 = 0.5 * (dvdz + dwdy)
                Sm2 = dudx**2 + dvdy**2 + dwdz**2 \
                    + 2.0 * (S12**2 + S13**2 + S23**2)
                out = 0.5 * (Om2 - Sm2)
            else:
                raise ValueError(f"unknown vis mode {mode}")

    return jnp.where(s.solid, 0.0, out)
