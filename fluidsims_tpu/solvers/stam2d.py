"""Jos Stam "Stable Fluids" on an exponentially stretched (log-η) grid.

Behavioral spec: js_cuda.cu — 512² double-precision solver with:
  * log-η metric x = X0*e^η, η ∈ [-1.5, 1.5]; per-axis cell widths
    dx[i] = X0(e^{η+dη/2} - e^{η-dη/2}) (init_grid :196-214)
  * 40-iteration Jacobi linear solves for diffusion and pressure
    (k_lin :70-80, lin_solve :143-158)
  * semi-Lagrangian advection back-tracing in η-space with velocity
    converted by 1/x_p (k_adv :82-103), sample clamped to [0.5, N+0.5]
  * projection: central divergence scaled by 1/dx then gradient subtraction
    scaled by dx (k_div :105-114, k_proj :116-124)
  * density decay (1-1e-6) and an orbiting animated swirl source
    (k_decay :49-54, k_add_source :126-140), initial swirl seed (k_seed :56-68)
  * a zero halo ring (the (N+2)² padding is memset once and never written).

Design: fields are stored as interior (N, N) arrays; the zero ring is
realized by jnp.pad at use sites.  The Jacobi loop is a lax.fori_loop; the
bilinear back-trace is the reference's exact per-cell gather, on
flattened 1-D indices (ops/gather.py).  Everything under one jit.
Default dtype float32 (the reference is f64; dtype="float64" matches it
exactly under x64).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import BaseConfig

__all__ = ["Stam2DConfig", "Stam2DState", "init", "step", "run"]


@dataclass(frozen=True)
class Stam2DConfig(BaseConfig):
    n: int = 512
    dt: float = 1.0
    visc: float = 1e-6
    diff: float = 1e-7
    dens_decay: float = 1.0 - 1e-6
    x0: float = 1.0
    y0: float = 1.0
    eta_min: float = -1.5
    eta_max: float = 1.5
    jacobi_iters: int = 40
    # x-slab sharded runner (parallel/stam2d_sharded.py): advection ghost
    # columns per shard; backtraces farther than this are clamped to the halo edge and
    # counted in state.ovf
    advect_band: int = 16
    dtype: str = "float32"

    def validate(self):
        self._require(self.n > 0, "n must be positive")
        self._require(self.jacobi_iters > 0, "jacobi_iters must be positive")
        self._require(self.eta_max > self.eta_min, "eta range must be nonempty")
        self._require(1 <= self.advect_band <= 128,
                      "advect_band must be in [1, 128]")


class Stam2DState(NamedTuple):
    u: jnp.ndarray   # (n, n) interior velocities
    v: jnp.ndarray
    u0: jnp.ndarray  # scratch fields carried across steps (warm-started
    v0: jnp.ndarray  # Jacobi initial guesses, as in the reference's reuse
    d: jnp.ndarray   # of d_u0/d_v0/d_d0 buffers)
    d0: jnp.ndarray
    step_idx: jnp.ndarray  # drives the orbiting source phase
    ovf: jnp.ndarray  # cumulative cells clamped by the sharded runner's
    #                   advect_band across ALL frames (0 on one device)


def _eta(cfg, idx):
    deta = (cfg.eta_max - cfg.eta_min) / cfg.n
    return cfg.eta_min + (idx - 0.5) * deta


def _cell_widths(cfg):
    """Physical cell widths along one axis (init_grid, js_cuda.cu:196-207)."""
    deta = (cfg.eta_max - cfg.eta_min) / cfg.n
    i = np.arange(1, cfg.n + 1)
    eta = cfg.eta_min + (i - 0.5) * deta
    w = cfg.x0 * (np.exp(eta + deta / 2) - np.exp(eta - deta / 2))
    return w


def init(cfg: Stam2DConfig) -> Stam2DState:
    n = cfg.n
    dt = cfg.jax_dtype
    z = jnp.zeros((n, n), dt)
    s = Stam2DState(u=z, v=z, u0=z, v0=z, d=z, d0=z,
                    step_idx=jnp.asarray(0, jnp.int32),
                    ovf=jnp.asarray(0, jnp.int32))
    return _seed(cfg, s)


def _seed(cfg, s: Stam2DState) -> Stam2DState:
    """Initial swirl + Gaussian density blob (k_seed, js_cuda.cu:56-68)."""
    n = cfg.n
    i = np.arange(1, n + 1)[None, :]
    j = np.arange(1, n + 1)[:, None]
    cx = cy = n // 2
    R = n / 2.5
    sw = 0.5
    dx = i - cx
    dy = j - cy
    r2 = dx * dx + dy * dy
    r = np.sqrt(r2) + 1e-6
    inside = r2 < R * R
    d_add = np.where(inside, 0.4 * np.exp(-r2 / (R * R)), 0.0)
    u_new = np.where(inside, -sw * dy / r, np.asarray(s.u))
    v_new = np.where(inside, sw * dx / r, np.asarray(s.v))
    dt = cfg.jax_dtype
    return s._replace(
        u=jnp.asarray(u_new, dt),
        v=jnp.asarray(v_new, dt),
        d=s.d + jnp.asarray(d_add, dt),
    )


def _sum4(x):
    """Sum of the 4 neighbors with the zero halo ring realized by padding."""
    p = jnp.pad(x, 1)
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]


def _lin_solve(cfg, x, x0, a, c):
    """Jacobi iterations x <- (x0 + a*sum4(x))/c (k_lin + lin_solve,
    js_cuda.cu:70-80,143-158), warm-started from the passed-in x."""

    def body(_, xk):
        return (x0 + a * _sum4(xk)) / c

    return lax.fori_loop(0, cfg.jacobi_iters, body, x)


def _backtrace_coords(cfg, uu, vv):
    """Exact semi-Lagrangian back-trace coordinates in η-space (k_adv,
    js_cuda.cu:82-103): padded-space corner indices (i0, j0) in [0, n]
    and fractional weights (s1, t1)."""
    n = cfg.n
    deta = (cfg.eta_max - cfg.eta_min) / n
    idx = jnp.arange(1, n + 1, dtype=uu.dtype)
    eta_x = cfg.eta_min + (idx - 0.5) * deta   # per column
    eta_y = eta_x                               # same metric per row
    xp = cfg.x0 * jnp.exp(eta_x)[None, :]
    yp = cfg.y0 * jnp.exp(eta_y)[:, None]

    bx = eta_x[None, :] - cfg.dt * uu / xp
    by = eta_y[:, None] - cfg.dt * vv / yp
    sarr = (bx - cfg.eta_min) / deta + 0.5
    tarr = (by - cfg.eta_min) / deta + 0.5
    sarr = jnp.clip(sarr, 0.5, n + 0.5)
    tarr = jnp.clip(tarr, 0.5, n + 0.5)

    i0 = jnp.floor(sarr).astype(jnp.int32)   # in [0, n]
    j0 = jnp.floor(tarr).astype(jnp.int32)
    s1 = sarr - i0
    t1 = tarr - j0
    return i0, j0, s1, t1


def _bilinear(qp, i0, j0, s1, t1):
    """Exact 4-corner fetch + blend on the ring-padded array (any index
    shape; the association matches k_adv)."""
    from ..ops.gather import gather2d

    s0 = 1.0 - s1
    t0 = 1.0 - t1
    q00 = gather2d(qp, j0, i0)
    q01 = gather2d(qp, j0 + 1, i0)
    q10 = gather2d(qp, j0, i0 + 1)
    q11 = gather2d(qp, j0 + 1, i0 + 1)
    return s0 * (t0 * q00 + t1 * q01) + s1 * (t0 * q10 + t1 * q11)


def _advect(cfg, q0, uu, vv):
    """Semi-Lagrangian back-trace in η-space (k_adv, js_cuda.cu:82-103)."""
    i0, j0, s1, t1 = _backtrace_coords(cfg, uu, vv)
    qp = jnp.pad(q0, 1)  # (n+2, n+2); ring = 0, index space matches IX
    return _bilinear(qp, i0, j0, s1, t1)


def _project(cfg, uu, vv, dx_w, dy_w, lin_solve=None):
    """Divergence -> 40-iter Jacobi Poisson (from p=0) -> gradient subtract
    (k_div/k_proj + lin_solve, js_cuda.cu:105-124,170-181).  The reference
    divides by the cell widths; this multiplies by their reciprocals
    (identical to ~1 ulp) so the expression is division-rewrite-proof —
    XLA folds X/const into X*(1/const) for compile-time-constant widths
    but not for runtime operands, which would break the bitwise
    single-chip/sharded equivalence gate (tests/test_stam_sharded.py)."""
    if lin_solve is None:
        lin_solve = lambda x, b, a, c: _lin_solve(cfg, x, b, a, c)  # noqa: E731
    inv_dx = 1.0 / dx_w
    inv_dy = 1.0 / dy_w
    pu = jnp.pad(uu, 1)
    pv = jnp.pad(vv, 1)
    div = -0.5 * (
        (pu[1:-1, 2:] - pu[1:-1, :-2]) * inv_dx[None, :]
        + (pv[2:, 1:-1] - pv[:-2, 1:-1]) * inv_dy[:, None]
    )
    p = lin_solve(jnp.zeros_like(div), div, 1.0, 4.0)
    pp = jnp.pad(p, 1)
    uu = uu - 0.5 * dx_w[None, :] * (pp[1:-1, 2:] - pp[1:-1, :-2])
    vv = vv - 0.5 * dy_w[:, None] * (pp[2:, 1:-1] - pp[:-2, 1:-1])
    return uu, vv


def _add_source(cfg, u, v, d, step_idx):
    """Orbiting animated swirl source (k_add_source, js_cuda.cu:126-140)."""
    n = cfg.n
    ang = step_idx.astype(u.dtype) * 0.015
    # C's (int) cast truncates toward zero (js_cuda.cu:130-131)
    cx = n // 2 + jnp.trunc((n / 4) * jnp.cos(ang)).astype(jnp.int32)
    cy = n // 2 + jnp.trunc((n / 4) * jnp.sin(ang)).astype(jnp.int32)
    R = 3.0
    swirl = 0.6
    amp = 0.5 + 0.4 * jnp.sin(step_idx.astype(u.dtype) * 0.02)

    i = jnp.arange(1, n + 1)[None, :]
    j = jnp.arange(1, n + 1)[:, None]
    dx = (i - cx).astype(u.dtype)
    dy = (j - cy).astype(u.dtype)
    r2 = dx * dx + dy * dy
    r = jnp.sqrt(r2) + 1e-6
    inside = r2 < R * R
    d = d + jnp.where(inside, amp * jnp.exp(-r2 / (R * R)), 0.0)
    u = u + jnp.where(inside, -swirl * dy / r, 0.0)
    v = v + jnp.where(inside, swirl * dx / r, 0.0)
    return u, v, d


def step(cfg: Stam2DConfig, s: Stam2DState) -> Stam2DState:
    """One frame: decay -> source -> vel_step -> dens_step
    (main loop, js_cuda.cu:361-368)."""
    dx_w = jnp.asarray(_cell_widths(cfg), cfg.jax_dtype)
    dy_w = dx_w

    def advect_pair(qa, qb, uu, vv):
        return _advect(cfg, qa, uu, vv), _advect(cfg, qb, uu, vv)

    def lin_solve(x, b, a, c):
        return _lin_solve(cfg, x, b, a, c)

    def diffuse(x, x0, coeff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        return lin_solve(x, x0, a, 1.0 + 4.0 * a)

    d = s.d * cfg.dens_decay
    u, v, d = _add_source(cfg, s.u, s.v, d, s.step_idx)

    # vel_step (js_cuda.cu:165-182)
    u0 = diffuse(s.u0, u, cfg.visc)
    v0 = diffuse(s.v0, v, cfg.visc)
    u0, v0 = _project(cfg, u0, v0, dx_w, dy_w, lin_solve)
    u, v = advect_pair(u0, v0, u0, v0)
    u, v = _project(cfg, u, v, dx_w, dy_w, lin_solve)

    # dens_step (js_cuda.cu:184-191)
    d0 = diffuse(s.d0, d, cfg.diff)
    d = _advect(cfg, d0, u, v)

    return Stam2DState(u=u, v=v, u0=u0, v0=v0, d=d, d0=d0,
                       step_idx=s.step_idx + 1, ovf=s.ovf)


def run(cfg: Stam2DConfig, s: Stam2DState, n_steps: int) -> Stam2DState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
