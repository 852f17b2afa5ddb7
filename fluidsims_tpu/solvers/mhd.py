"""2-D ideal MHD with hyperbolic/parabolic GLM divergence cleaning.

Behavioral spec: tau_mhd.c — 7-component state (rho, mx, my, E, Bx, By, psi)
(:37-38); MUSCL reconstruction in CONSERVED variables with this file's own
MC-limiter composition mc(dl,dc,dr) = minmod(minmod(dl,dr),
minmod(dc, minmod(2dl,2dr))) (:48-49, 129-142 — note: different from the
hypersonic solvers' mc_limiter); GLM-augmented fluxes with cleaning speed
ch (:78-99); an HLLD-oriented wave model whose star states gate a robust
HLL flux (hlld_glm_flux :103-127 — the returned interior flux is always
HLL; SL/SR are widened by ±ch); face-pair conservative update over interior
cells only (:164-171); psi damping exp(-alpha ch dt/min(dx,dy)) and
invalid-update revert to the previous state (:172-173); Brio–Wu and
Orszag–Tang initial conditions (:144-157); dt = CFL*min(dx,dy)/(maxs+ch)
with ch = maxs (:160-162); view modes rho/p/|B|/|divB| (:178-183).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.config import BaseConfig
from ..ops.limiters import minmod
from ..ops.shift import shift_clamped, shift_wrapped

__all__ = ["MHDConfig", "MHDState", "ConsM", "init", "step", "run",
           "view_field"]

EPS_RHO = 1e-8
EPS_P = 1e-8
GLM_ALPHA = 0.18
FIELDS = ("rho", "mx", "my", "E", "Bx", "By", "psi")


class ConsM(NamedTuple):
    rho: jnp.ndarray
    mx: jnp.ndarray
    my: jnp.ndarray
    E: jnp.ndarray
    Bx: jnp.ndarray
    By: jnp.ndarray
    psi: jnp.ndarray


class PrimM(NamedTuple):
    rho: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    p: jnp.ndarray
    Bx: jnp.ndarray
    By: jnp.ndarray
    psi: jnp.ndarray


@dataclass(frozen=True)
class MHDConfig(BaseConfig):
    nx: int = 320
    ny: int = 220
    gamma: float = 1.4
    cfl: float = 0.22
    problem: str = "briowu"   # or "orszag-tang"
    # The reference's FHLL uses F = (SR FL - SL FR - SL SR (UR-UL))/(SR-SL)
    # (tau_mhd.c:123) — the OPPOSITE sign of the standard dissipative HLL
    # term. That anti-diffusive flux is kept as the default for behavioral
    # parity (the reference survives via its invalid-cell revert, :173);
    # stable_hll=True switches to the textbook sign.
    stable_hll: bool = False
    dtype: str = "float32"

    def validate(self):
        self._require(self.nx > 4 and self.ny > 4, "grid too small")
        self._require(self.gamma > 1.0, "gamma must be > 1")
        self._require(self.problem in ("briowu", "orszag-tang"),
                      f"unknown problem {self.problem}")


class MHDState(NamedTuple):
    U: ConsM
    t: jnp.ndarray


def _map(f, *cs):
    return ConsM(*(f(*vals) for vals in zip(*cs)))


def cons_to_prim(U: ConsM, gamma: float) -> PrimM:
    rho = jnp.maximum(U.rho, EPS_RHO)
    u = U.mx / rho
    v = U.my / rho
    ek = 0.5 * rho * (u * u + v * v)
    em = 0.5 * (U.Bx**2 + U.By**2)
    p = jnp.maximum((gamma - 1.0) * (U.E - ek - em), EPS_P)
    return PrimM(rho=rho, u=u, v=v, p=p, Bx=U.Bx, By=U.By, psi=U.psi)


def prim_to_cons(q: PrimM, gamma: float) -> ConsM:
    rho = jnp.maximum(q.rho, EPS_RHO)
    p = jnp.maximum(q.p, EPS_P)
    return ConsM(
        rho=rho, mx=rho * q.u, my=rho * q.v,
        E=p / (gamma - 1.0) + 0.5 * rho * (q.u**2 + q.v**2)
        + 0.5 * (q.Bx**2 + q.By**2),
        Bx=q.Bx, By=q.By, psi=q.psi,
    )


def fast_speed(q: PrimM, gamma: float, xdir: bool):
    """Fast magnetosonic speed estimate (tau_mhd.c:70-76)."""
    a2 = gamma * q.p / q.rho
    b2 = (q.Bx**2 + q.By**2) / q.rho
    bn2 = (q.Bx if xdir else q.By) ** 2 / q.rho
    disc = jnp.maximum((a2 + b2) ** 2 - 4.0 * a2 * bn2, 0.0)
    return jnp.sqrt(0.5 * ((a2 + b2) + jnp.sqrt(disc)))


def glm_flux(U: ConsM, gamma: float, ch, xdir: bool) -> ConsM:
    """GLM-augmented ideal-MHD flux (flux_x/flux_y, tau_mhd.c:78-99)."""
    q = cons_to_prim(U, gamma)
    pt = q.p + 0.5 * (q.Bx**2 + q.By**2)
    vb = q.u * q.Bx + q.v * q.By
    if xdir:
        return ConsM(
            rho=U.mx,
            mx=U.mx * q.u + pt - q.Bx**2,
            my=U.my * q.u - q.Bx * q.By,
            E=(U.E + pt) * q.u - q.Bx * vb,
            Bx=q.psi,
            By=q.u * q.By - q.v * q.Bx,
            psi=ch * ch * q.Bx,
        )
    return ConsM(
        rho=U.my,
        mx=U.mx * q.v - q.By * q.Bx,
        my=U.my * q.v + pt - q.By**2,
        E=(U.E + pt) * q.v - q.By * vb,
        Bx=q.v * q.Bx - q.u * q.By,
        By=q.psi,
        psi=ch * ch * q.By,
    )


def hlld_glm_flux(UL: ConsM, UR: ConsM, gamma: float, ch, xdir: bool,
                  stable: bool = False) -> ConsM:
    """HLLD-oriented wave model gating a robust HLL flux
    (tau_mhd.c:103-127): star states are computed only to detect
    pathological (non-finite / non-positive total pressure) cases; the
    interior flux is the HLL flux in either case — exactly as the reference,
    where the HLLD branch falls through to FHLL."""
    L = cons_to_prim(UL, gamma)
    R = cons_to_prim(UR, gamma)
    unL = L.u if xdir else L.v
    unR = R.u if xdir else R.v
    cfL = fast_speed(L, gamma, xdir)
    cfR = fast_speed(R, gamma, xdir)
    SL = jnp.minimum(jnp.minimum(unL - cfL, unR - cfR), -ch)
    SR = jnp.maximum(jnp.maximum(unL + cfL, unR + cfR), ch)

    FL = glm_flux(UL, gamma, ch, xdir)
    FR = glm_flux(UR, gamma, ch, xdir)

    inv = 1.0 / (SR - SL)  # SR >= ch > 0 > -ch >= SL, never degenerate
    sgn = 1.0 if stable else -1.0
    FHLL = _map(
        lambda fl, fr, ul, ur: (SR * fl - SL * fr
                                + sgn * SL * SR * (ur - ul)) * inv,
        FL, FR, UL, UR,
    )
    return _map(
        lambda fl, fr, fh: jnp.where(SL >= 0.0, fl,
                                     jnp.where(SR <= 0.0, fr, fh)),
        FL, FR, FHLL,
    )


def _mc(dl, dc, dr):
    """This solver's own limiter composition (tau_mhd.c:49)."""
    return minmod(minmod(dl, dr), minmod(dc, minmod(2.0 * dl, 2.0 * dr)))


def _slopes(U: ConsM, dy: int, dx: int) -> ConsM:
    """MC-limited slopes on conserved variables (slope_at/slope_y_at,
    tau_mhd.c:129-142), with edge-clamped neighbors (only interior values
    are consumed)."""

    def s(f):
        fm = shift_clamped(f, -dy, -dx)
        fp = shift_clamped(f, dy, dx)
        return _mc(f - fm, 0.5 * (fp - fm), fp - f)

    return ConsM(*(s(f) for f in U))


def init(cfg: MHDConfig) -> MHDState:
    nx, ny = cfg.nx, cfg.ny
    X = (np.arange(nx)[None, :] + 0.5) / nx
    Y = (np.arange(ny)[:, None] + 0.5) / ny
    g = cfg.gamma

    if cfg.problem == "briowu":
        left = X < 0.5
        rho = np.where(left, 1.0, 0.125) * np.ones((ny, nx))
        p = np.where(left, 1.0, 0.1) * np.ones((ny, nx))
        By = np.where(left, 1.0, -1.0) * np.ones((ny, nx))
        Bx = np.full((ny, nx), 0.75)
        u = np.zeros((ny, nx))
        v = 0.03 * np.sin(12.0 * Y) * np.ones((ny, nx))
    else:
        rho = np.full((ny, nx), g * g)
        p = np.full((ny, nx), g)
        u = (-np.sin(2 * np.pi * Y)) * np.ones((ny, nx))
        v = np.sin(2 * np.pi * X) * np.ones((ny, nx))
        Bx = (-np.sin(2 * np.pi * Y) / np.sqrt(4 * np.pi)) * np.ones((ny, nx))
        By = (np.sin(4 * np.pi * X) / np.sqrt(4 * np.pi)) * np.ones((ny, nx))

    dt = cfg.jax_dtype
    q = PrimM(
        rho=jnp.asarray(rho, dt), u=jnp.asarray(u, dt), v=jnp.asarray(v, dt),
        p=jnp.asarray(p, dt), Bx=jnp.asarray(Bx, dt), By=jnp.asarray(By, dt),
        psi=jnp.zeros((ny, nx), dt),
    )
    return MHDState(U=prim_to_cons(q, g), t=jnp.asarray(0.0, dt))


def _zero_shift_x(fx):
    """fxm[y, x] = fx[y, x-1], zero-filled at x=0 (the pair term of the
    conservative face-scatter update)."""
    return jnp.pad(fx, ((0, 0), (1, 0)))[:, :-1]


def _zero_shift_y(fy):
    return jnp.pad(fy, ((1, 0), (0, 0)))[:-1, :]


def default_face_masks(nx: int, ny: int):
    """Interior face bands: x faces (flux between cells x and x+1) for
    x in [1, nx-3], y in [1, ny-2] (tau_mhd.c:164-167); y faces for
    y in [1, ny-3], x in [1, nx-2]."""
    mx_face = np.zeros((ny, nx), bool)
    mx_face[1:ny - 1, 1:nx - 2] = True
    my_face = np.zeros((ny, nx), bool)
    my_face[1:ny - 2, 1:nx - 1] = True
    return jnp.asarray(mx_face), jnp.asarray(my_face)


def step_core(cfg: MHDConfig, U: ConsM, *, face_masks=None, dxdy=None,
              wavespeed_reduce=None):
    """One MHD+GLM step on the raw conserved fields; returns (Un, dt)."""
    g = cfg.gamma
    nx, ny = cfg.nx, cfg.ny
    dx, dy = dxdy if dxdy is not None else (1.0 / nx, 1.0 / ny)

    q = cons_to_prim(U, g)
    maxs = jnp.max(
        jnp.hypot(q.u, q.v)
        + jnp.maximum(fast_speed(q, g, True), fast_speed(q, g, False))
    )
    if wavespeed_reduce is not None:
        maxs = wavespeed_reduce(maxs)
    maxs = jnp.maximum(maxs, 1e-6)
    ch = maxs
    dt = cfg.cfl * min(dx, dy) / jnp.maximum(maxs + ch, 1e-6)

    if face_masks is None:
        mx_face, my_face = default_face_masks(nx, ny)
    else:
        mx_face, my_face = face_masks

    Sx = _slopes(U, 0, 1)
    qL = _map(lambda u_, sl: u_ + 0.5 * sl, U, Sx)
    qR_all = _map(lambda u_, sl: u_ - 0.5 * sl, U, Sx)
    qR = ConsM(*(shift_clamped(f, 0, 1) for f in qR_all))
    Fx = hlld_glm_flux(qL, qR, g, ch, True, cfg.stable_hll)
    Fx = _map(lambda f: jnp.where(mx_face, f, 0.0), Fx)

    Sy = _slopes(U, 1, 0)
    qB = _map(lambda u_, sl: u_ + 0.5 * sl, U, Sy)
    qT_all = _map(lambda u_, sl: u_ - 0.5 * sl, U, Sy)
    qT = ConsM(*(shift_clamped(f, 1, 0) for f in qT_all))
    Fy = hlld_glm_flux(qB, qT, g, ch, False, cfg.stable_hll)
    Fy = _map(lambda f: jnp.where(my_face, f, 0.0), Fy)

    # conservative pair update: cell c gets -(Fx[c] - Fx[c-1])*dt/dx etc.
    def upd(u_, fx, fy):
        return (u_ - (dt / dx) * (fx - _zero_shift_x(fx))
                - (dt / dy) * (fy - _zero_shift_y(fy)))

    Un = _map(upd, U, Fx, Fy)

    # psi damping + invalid-update revert (tau_mhd.c:172-173)
    damp = jnp.exp(-GLM_ALPHA * ch * dt / min(dx, dy))
    Un = Un._replace(psi=Un.psi * damp)

    qn = cons_to_prim(Un, g)
    ok = jnp.isfinite(Un.E) & (qn.rho > EPS_RHO) & (qn.p > EPS_P)
    for f in Un:
        ok = ok & jnp.isfinite(f)
    Un = _map(lambda new, old: jnp.where(ok, new, old), Un, U)
    return Un, dt


def step(cfg: MHDConfig, s: MHDState, wavespeed_reduce=None,
         face_masks=None, dxdy=None) -> MHDState:
    """Sharding hooks (all default to the dense single-device behavior):
    `wavespeed_reduce` extends the dt/ch max across devices (lax.pmax);
    `face_masks=(mx, my)` overrides the interior face-band masks when the
    local slab's global column range differs from [0, nx); `dxdy` fixes the
    physical spacing when cfg.nx is a local (extended) width."""
    Un, dt = step_core(cfg, s.U, face_masks=face_masks, dxdy=dxdy,
                       wavespeed_reduce=wavespeed_reduce)
    return MHDState(U=Un, t=s.t + dt)


def view_field(cfg: MHDConfig, s: MHDState, mode: int):
    """View scalars rho / p / |B| / |divB| (draw_pixels, tau_mhd.c:178-183)."""
    q = cons_to_prim(s.U, cfg.gamma)
    if mode == 0:
        return (q.rho - 0.1) / 2.2
    if mode == 1:
        return q.p / 2.0
    if mode == 2:
        return jnp.hypot(q.Bx, q.By) / 1.6
    div = jnp.abs(
        (shift_wrapped(s.U.Bx, 0, 1) - shift_wrapped(s.U.Bx, 0, -1)) * 0.5
        * cfg.nx
        + (shift_wrapped(s.U.By, 1, 0) - shift_wrapped(s.U.By, -1, 0)) * 0.5
        * cfg.ny
    )
    return div * 0.05


def run(cfg: MHDConfig, s: MHDState, n_steps: int) -> MHDState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
