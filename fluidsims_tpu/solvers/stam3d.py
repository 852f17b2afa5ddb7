"""3-D Jos Stam stable fluids with reflective boundaries and isometric
terminal splatting.

Behavioral spec: js_cuda3d.cu — (N+2)^3 float32 fields with an actively
maintained ghost ring via set_bnd reflections (k_set_bnd :119-157, applied
at the reference's exact points in vel_step/dens_step :333-363); 12-iter
Jacobi diffusion (a = dt*c*N^2, denom 1+6a) and pressure solves (:297-322);
trilinear semi-Lagrangian advection with backtrace clamped to [0.5, N+0.5]
(k_adv3d :192-237); density decay + orbiting 3-D source (k_decay :91-97,
k_add_source3d :99-117); ABC-flow + xorshift-noise turbulence seed
(k_seed_turbulence :365-420, seeded then projected :422-431); isometric
additive splatting with tone-map 1-exp(-gain*a) and gamma
(k_iso_accumulate :239-273, k_finalize_screen :275-295).

Design: state carries the full (N+2)^3 arrays including ghost rings so
set_bnd's buffer-state semantics (stale rings during Jacobi) are replicated
exactly; interior updates are static slice writes; the iso splat's
atomicAdd becomes a 4-corner scatter-add.

Advection has two forms: advect_k=0 is the reference's exact per-cell
trilinear gather; advect_k=K >= 1 is a dense shift form that is exact
while no backtrace exceeds K cells; `advect_capped_count` reports
violations (the CLI prints a warning).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import BaseConfig

__all__ = ["Stam3DConfig", "Stam3DState", "init", "step", "run",
           "advect_capped_count", "iso_render"]


@dataclass(frozen=True)
class Stam3DConfig(BaseConfig):
    n: int = 192
    dt: float = 1.0
    visc: float = 1e-5
    diff: float = 1e-6
    decay: float = 0.9
    src_gain: float = 0.25
    src_freq: float = 0.02
    seed_amp: float = 1.2
    seed_noise: float = 0.25
    seed_dens_amp: float = 0.8
    seed_sigma: float = 0.12
    jacobi_iters: int = 12
    seed: int = 1337
    # semi-Lagrangian advection kernel: 0 = exact per-cell gather
    # (k_adv3d semantics, the default: exact, and on the H100 faster than
    # the shift form — PERF.md, engine A/B); K >= 1 = dense shift form,
    # exact for backtrace displacements <= K cells (farther backtraces are
    # capped at K; `advect_capped_count` reports how many cells were
    # capped).
    advect_k: int = 0
    dtype: str = "float32"

    def validate(self):
        self._require(self.n >= 8, "n must be >= 8")
        self._require(self.jacobi_iters > 0, "jacobi_iters must be positive")
        self._require(0 <= self.advect_k <= 8, "advect_k must be in [0, 8]")


class Stam3DState(NamedTuple):
    # full (n+2)^3 arrays, ghost ring included; indexed [k, j, i] = (z, y, x)
    u: jnp.ndarray
    v: jnp.ndarray
    w: jnp.ndarray
    u0: jnp.ndarray
    v0: jnp.ndarray
    w0: jnp.ndarray
    d: jnp.ndarray
    d0: jnp.ndarray
    step_idx: jnp.ndarray


def _interior(f):
    return f[1:-1, 1:-1, 1:-1]


def _set_interior(f, val):
    return f.at[1:-1, 1:-1, 1:-1].set(val)


def set_bnd(u, v, w, d):
    """Reflective velocity walls + copy density ghost (k_set_bnd,
    js_cuda3d.cu:119-157). Index order here is [z, y, x]; the reference's
    'X faces' are the x-axis (last index)."""
    # X faces: u reflects, others copy
    u = u.at[1:-1, 1:-1, 0].set(-u[1:-1, 1:-1, 1])
    u = u.at[1:-1, 1:-1, -1].set(-u[1:-1, 1:-1, -2])
    v = v.at[1:-1, 1:-1, 0].set(v[1:-1, 1:-1, 1])
    v = v.at[1:-1, 1:-1, -1].set(v[1:-1, 1:-1, -2])
    w = w.at[1:-1, 1:-1, 0].set(w[1:-1, 1:-1, 1])
    w = w.at[1:-1, 1:-1, -1].set(w[1:-1, 1:-1, -2])
    # Y faces: v reflects
    v = v.at[1:-1, 0, 1:-1].set(-v[1:-1, 1, 1:-1])
    v = v.at[1:-1, -1, 1:-1].set(-v[1:-1, -2, 1:-1])
    u = u.at[1:-1, 0, 1:-1].set(u[1:-1, 1, 1:-1])
    u = u.at[1:-1, -1, 1:-1].set(u[1:-1, -2, 1:-1])
    w = w.at[1:-1, 0, 1:-1].set(w[1:-1, 1, 1:-1])
    w = w.at[1:-1, -1, 1:-1].set(w[1:-1, -2, 1:-1])
    # Z faces: w reflects
    w = w.at[0, 1:-1, 1:-1].set(-w[1, 1:-1, 1:-1])
    w = w.at[-1, 1:-1, 1:-1].set(-w[-2, 1:-1, 1:-1])
    u = u.at[0, 1:-1, 1:-1].set(u[1, 1:-1, 1:-1])
    u = u.at[-1, 1:-1, 1:-1].set(u[-2, 1:-1, 1:-1])
    v = v.at[0, 1:-1, 1:-1].set(v[1, 1:-1, 1:-1])
    v = v.at[-1, 1:-1, 1:-1].set(v[-2, 1:-1, 1:-1])
    # density: copy on all faces
    d = d.at[1:-1, 1:-1, 0].set(d[1:-1, 1:-1, 1])
    d = d.at[1:-1, 1:-1, -1].set(d[1:-1, 1:-1, -2])
    d = d.at[1:-1, 0, 1:-1].set(d[1:-1, 1, 1:-1])
    d = d.at[1:-1, -1, 1:-1].set(d[1:-1, -2, 1:-1])
    d = d.at[0, 1:-1, 1:-1].set(d[1, 1:-1, 1:-1])
    d = d.at[-1, 1:-1, 1:-1].set(d[-2, 1:-1, 1:-1])
    return u, v, w, d


def _sum6(f):
    return (
        f[1:-1, 1:-1, :-2] + f[1:-1, 1:-1, 2:]
        + f[1:-1, :-2, 1:-1] + f[1:-1, 2:, 1:-1]
        + f[:-2, 1:-1, 1:-1] + f[2:, 1:-1, 1:-1]
    )


def _lin_solve(cfg, x, x0, a, c):
    """Jacobi ping-pong exactly as lin_solve (js_cuda3d.cu:297-313): only
    interiors are written, so reads alternate between the x buffer's ghost
    ring (even read iterations) and the zeroed scratch buffer's (odd) —
    k_set_bnd populates the ghosts of u0/v0/w0/d0, so the alternation is
    observable at the boundary ring.  An even iteration count lands in the
    x buffer (x's ghosts survive on the result)."""
    x0i = _interior(x0)
    zeros = jnp.zeros_like(x)

    def body(it, xk):
        interior = (x0i + a * _sum6(xk)) / c
        # the buffer written at iteration `it` (and read at it+1):
        # even it -> the zeroed scratch, odd it -> the x buffer
        base = jnp.where((it % 2) == 0, zeros, x)
        return _set_interior(base, interior)

    out = lax.fori_loop(0, cfg.jacobi_iters, body, x)
    if cfg.jacobi_iters % 2:
        # odd count: the reference memcpys the scratch (zero ghosts) into x
        out = _set_interior(zeros, _interior(out))
    return out


def _diffuse(cfg, x, x0, coeff):
    a = cfg.dt * coeff * cfg.n * cfg.n
    return _lin_solve(cfg, x, x0, a, 1.0 + 6.0 * a)


def _advect_dense(cfg, q0, u, v, w):
    """Dense-shift trilinear advection: with the backtrace displacement
    capped to +-K cells, the interpolation weight of source offset o is
    the hat function max(0, 1 - |x - (I+o)|), nonzero only for the two
    offsets trilinear uses — so the sum over the (2K+1)^3 static-shift
    neighborhood reproduces the gather path exactly whenever |dt*u| <= K.
    (Offset K+1 is never needed: with d = clip(x - base, -K, K) the hat
    weight max(0, 1 - |d - (K+1)|) is identically zero, including the
    d == K cap where it is exactly 0 — so offsets -K..K suffice.)
    Replaces 8 per-cell gathers with fused shift-multiply-adds."""
    n = cfg.n
    K = cfg.advect_k
    dt_ = cfg.dt
    idx = jnp.arange(1, n + 1, dtype=q0.dtype)
    I = idx[None, None, :]
    J = idx[None, :, None]
    Kz = idx[:, None, None]

    def backtrace(base, vel):
        x = jnp.clip(base - dt_ * _interior(vel), 0.5, n + 0.5)
        return base + jnp.clip(x - base, -K, K)

    x = backtrace(I, u)
    y = backtrace(J, v)
    z = backtrace(Kz, w)

    # per-axis hat weights for each offset; broadcast to (n, n, n) lazily
    def hat(pos, base, o):
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos - (base + o)))

    offs = list(range(-K, K + 1))
    wx = [hat(x, I, o) for o in offs]
    wy = [hat(y, J, o) for o in offs]
    wz = [hat(z, Kz, o) for o in offs]

    qp = jnp.pad(q0, K, mode="edge")  # values at capped range, weight 0
    acc = jnp.zeros((n, n, n), q0.dtype)
    for iz, oz in enumerate(offs):
        for iy, oy in enumerate(offs):
            wzy = wz[iz] * wy[iy]
            for ix, ox in enumerate(offs):
                sl = qp[
                    1 + K + oz: 1 + K + oz + n,
                    1 + K + oy: 1 + K + oy + n,
                    1 + K + ox: 1 + K + ox + n,
                ]
                acc = acc + (wzy * wx[ix]) * sl
    return _set_interior(jnp.zeros_like(q0) + q0, acc)


def _advect(cfg, q0, u, v, w):
    """Trilinear semi-Lagrangian backtrace (k_adv3d, js_cuda3d.cu:192-237).
    Returns a full array with the interior replaced (ring preserved)."""
    if cfg.advect_k > 0:
        return _advect_dense(cfg, q0, u, v, w)
    n = cfg.n
    dt_ = cfg.dt
    idx = jnp.arange(1, n + 1, dtype=q0.dtype)
    I = idx[None, None, :]
    J = idx[None, :, None]
    K = idx[:, None, None]

    x = I - dt_ * _interior(u)
    y = J - dt_ * _interior(v)
    z = K - dt_ * _interior(w)
    x = jnp.clip(x, 0.5, n + 0.5)
    y = jnp.clip(y, 0.5, n + 0.5)
    z = jnp.clip(z, 0.5, n + 0.5)

    i0 = jnp.floor(x).astype(jnp.int32)
    j0 = jnp.floor(y).astype(jnp.int32)
    k0 = jnp.floor(z).astype(jnp.int32)
    sx = x - i0
    sy = y - j0
    sz = z - k0

    from ..ops.gather import gather3d

    def g(kk, jj, ii):
        return gather3d(q0, kk, jj, ii)

    c000 = g(k0, j0, i0)
    c100 = g(k0, j0, i0 + 1)
    c010 = g(k0, j0 + 1, i0)
    c110 = g(k0, j0 + 1, i0 + 1)
    c001 = g(k0 + 1, j0, i0)
    c101 = g(k0 + 1, j0, i0 + 1)
    c011 = g(k0 + 1, j0 + 1, i0)
    c111 = g(k0 + 1, j0 + 1, i0 + 1)

    c00 = (1 - sx) * c000 + sx * c100
    c10 = (1 - sx) * c010 + sx * c110
    c01 = (1 - sx) * c001 + sx * c101
    c11 = (1 - sx) * c011 + sx * c111
    c0 = (1 - sy) * c00 + sy * c10
    c1 = (1 - sy) * c01 + sy * c11
    return _set_interior(jnp.zeros_like(q0) + q0, (1 - sz) * c0 + sz * c1)


def _project(cfg, u, v, w, p_init):
    """div -> Jacobi Poisson -> gradient subtract (project,
    js_cuda3d.cu:316-322, k_div/k_proj :170-190)."""
    div = jnp.zeros_like(u)
    div = _set_interior(
        div,
        -0.5 * (
            (u[1:-1, 1:-1, 2:] - u[1:-1, 1:-1, :-2])
            + (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1])
            + (w[2:, 1:-1, 1:-1] - w[:-2, 1:-1, 1:-1])
        ),
    )
    p = _set_interior(p_init, jnp.zeros((cfg.n, cfg.n, cfg.n), u.dtype))
    p = _lin_solve(cfg, p, div, 1.0, 6.0)
    u = _set_interior(
        u, _interior(u) - 0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2])
    )
    v = _set_interior(
        v, _interior(v) - 0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1])
    )
    w = _set_interior(
        w, _interior(w) - 0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1])
    )
    return u, v, w, p


def _rand01(s):
    s = s.astype(jnp.uint32)
    s = s ^ (s << 13)
    s = s ^ (s >> 17)
    s = s ^ (s << 5)
    return s.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)


def init(cfg: Stam3DConfig) -> Stam3DState:
    """ABC-flow + noise turbulence seed, then set_bnd + projection
    (seed_initial_turbulence, js_cuda3d.cu:422-431)."""
    n = cfg.n
    dt = cfg.jax_dtype
    shape = (n + 2, n + 2, n + 2)
    z = jnp.zeros(shape, dt)

    idx = np.arange(1, n + 1)
    i = idx[None, None, :]
    j = idx[None, :, None]
    k = idx[:, None, None]
    xn = (i - 0.5) / n
    yn = (j - 0.5) / n
    zn = (k - 0.5) / n
    X = 2 * np.pi * xn
    Y = 2 * np.pi * yn
    Z = 2 * np.pi * zn
    A = cfg.seed_amp
    uu = A * np.sin(Z) + A * np.cos(Y)
    vv = A * np.sin(X) + A * np.cos(Z)
    ww = A * np.sin(Y) + A * np.cos(X)

    base = (np.uint32(cfg.seed)
            ^ (i.astype(np.uint32) * np.uint32(73856093))
            ^ (j.astype(np.uint32) * np.uint32(19349663))
            ^ (k.astype(np.uint32) * np.uint32(83492791)))

    def rand01_np(s):
        s = s.astype(np.uint32)
        s = s ^ (s << np.uint32(13))
        s = s ^ (s >> np.uint32(17))
        s = s ^ (s << np.uint32(5))
        return s.astype(np.float64) * 2.3283064365386963e-10

    uu = uu + cfg.seed_noise * (rand01_np(base + np.uint32(0)) - 0.5)
    vv = vv + cfg.seed_noise * (rand01_np(base + np.uint32(1)) - 0.5)
    ww = ww + cfg.seed_noise * (rand01_np(base + np.uint32(2)) - 0.5)

    dxn = xn - 0.5
    dyn = yn - 0.5
    dzn = zn - 0.5
    r2 = dxn**2 + dyn**2 + dzn**2
    g = np.exp(-r2 / (2.0 * cfg.seed_sigma**2))
    tex = 0.5 * (np.sin(2 * X) * np.sin(2 * Y) * np.sin(2 * Z) + 1.0)
    dens = cfg.seed_dens_amp * (g + 0.35 * tex)

    bro = lambda a: np.broadcast_to(a, (n, n, n))  # noqa: E731
    u = _set_interior(z, jnp.asarray(bro(uu), dt))
    v = _set_interior(z, jnp.asarray(bro(vv), dt))
    w = _set_interior(z, jnp.asarray(bro(ww), dt))
    d = _set_interior(z, jnp.asarray(bro(dens), dt))

    u, v, w, d = set_bnd(u, v, w, d)
    u, v, w, _ = _project(cfg, u, v, w, z)
    u, v, w, d = set_bnd(u, v, w, d)

    return Stam3DState(u=u, v=v, w=w, u0=z, v0=z, w0=z, d=d, d0=z,
                       step_idx=jnp.asarray(0, jnp.int32))


def _add_source(cfg, u, v, w, d, step_idx):
    """Orbiting swirl source (k_add_source3d, js_cuda3d.cu:99-117)."""
    n = cfg.n
    no4 = n / 4.0
    t = cfg.src_freq * step_idx.astype(u.dtype)
    idx = jnp.arange(1, n + 1, dtype=u.dtype)
    i = idx[None, None, :]
    j = idx[None, :, None]
    k = idx[:, None, None]
    dx = i - no4 * (1.0 + jnp.cos(t))
    dy = j - no4 * (1.0 + jnp.sin(t))
    dz = k - no4 * (1.0 + jnp.sin(t))
    r2 = dx * dx + dy * dy + dz * dz
    inside = r2 < n
    r = jnp.sqrt(r2) + 1e-7
    d = _set_interior(
        d, _interior(d) + jnp.where(inside, cfg.src_gain * jnp.exp(-r2 / n), 0.0)
    )
    u = _set_interior(u, _interior(u) + jnp.where(inside, dz / r, 0.0))
    v = _set_interior(v, _interior(v) + jnp.where(inside, dy / r, 0.0))
    w = _set_interior(w, _interior(w) + jnp.where(inside, dx / r, 0.0))
    return u, v, w, d


def advect_capped_count(cfg: Stam3DConfig, s: Stam3DState):
    """Cells whose backtrace displacement exceeds advect_k on any axis —
    i.e. where the dense advection deviates from the exact gather path.
    Zero means the frame's advection was exact.  Diagnostic (the CLI
    reports it per rendered frame)."""
    if cfg.advect_k < 1:
        return jnp.zeros((), jnp.int32)
    n = cfg.n
    K = float(cfg.advect_k)
    idx = jnp.arange(1, n + 1, dtype=s.u.dtype)
    I = idx[None, None, :]
    J = idx[None, :, None]
    Kz = idx[:, None, None]
    capped = jnp.zeros((n, n, n), bool)
    for base, vel in ((I, s.u), (J, s.v), (Kz, s.w)):
        x = jnp.clip(base - cfg.dt * _interior(vel), 0.5, n + 0.5)
        capped = capped | (jnp.abs(x - base) > K)
    return jnp.sum(capped)


def step(cfg: Stam3DConfig, s: Stam3DState) -> Stam3DState:
    """One frame: decay -> source -> vel_step -> dens_step with the reference's exact
    set_bnd placement (js_cuda3d.cu:333-363, main loop :629-700)."""
    u, v, w = s.u, s.v, s.w
    u0, v0, w0 = s.u0, s.v0, s.w0
    d, d0 = s.d, s.d0

    d = _set_interior(d, _interior(d) * cfg.decay)
    u, v, w, d = _add_source(cfg, u, v, w, d, s.step_idx)

    # vel_step
    u0 = _diffuse(cfg, u0, u, cfg.visc)
    v0 = _diffuse(cfg, v0, v, cfg.visc)
    w0 = _diffuse(cfg, w0, w, cfg.visc)
    u0, v0, w0, d = set_bnd(u0, v0, w0, d)
    u0, v0, w0, p = _project(cfg, u0, v0, w0, jnp.zeros_like(u0))
    u0, v0, w0, d = set_bnd(u0, v0, w0, d)
    u = _advect(cfg, u0, u0, v0, w0)
    v = _advect(cfg, v0, u0, v0, w0)
    w = _advect(cfg, w0, u0, v0, w0)
    u, v, w, d = set_bnd(u, v, w, d)
    u, v, w, p = _project(cfg, u, v, w, p)
    u, v, w, d = set_bnd(u, v, w, d)

    # dens_step
    d0 = _diffuse(cfg, d0, d, cfg.diff)
    u, v, w, d0 = set_bnd(u, v, w, d0)
    d = _advect(cfg, d0, u, v, w)
    u, v, w, d = set_bnd(u, v, w, d)

    return Stam3DState(u=u, v=v, w=w, u0=u0, v0=v0, w0=w0, d=d, d0=d0,
                       step_idx=s.step_idx + 1)


def iso_render(cfg: Stam3DConfig, s: Stam3DState, W: int, H: int,
               gain: float = 0.2, gamma: float = 1.2, levels: int = 256):
    """Isometric additive splat + tone map (k_iso_accumulate /
    k_finalize_screen, js_cuda3d.cu:239-295): returns int band indices
    (H, W)."""
    n = cfg.n
    sproj = min(W / (2.0 * n), H / (1.5 * n))
    cx = W * 0.5
    cy = H * 0.35

    idx = jnp.arange(1, n + 1, dtype=s.d.dtype)
    i = idx[None, None, :]
    j = idx[None, :, None]
    k = idx[:, None, None]
    val = jnp.sqrt(jnp.maximum(_interior(s.d), 0.0))

    X = (i - j) * sproj + cx
    Y = ((i + j) * 0.5 - k) * sproj + cy
    X = jnp.broadcast_to(X, val.shape).ravel()
    Y = jnp.broadcast_to(Y, val.shape).ravel()
    val = val.ravel()

    x0 = jnp.floor(X).astype(jnp.int32)
    y0 = jnp.floor(Y).astype(jnp.int32)
    fx = X - x0
    fy = Y - y0

    acc = jnp.zeros(W * H, s.d.dtype)
    for ox, oy, wgt in (
        (0, 0, (1 - fx) * (1 - fy)),
        (1, 0, fx * (1 - fy)),
        (0, 1, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xs = x0 + ox
        ys = y0 + oy
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        flat = jnp.where(ok, ys * W + xs, W * H)
        acc = acc.at[flat].add(jnp.where(ok, val * wgt, 0.0), mode="drop")

    y = 1.0 - jnp.exp(-gain * acc)
    y = jnp.clip(y**gamma, 0.0, 1.0)
    q = jnp.clip(jnp.floor(y * levels + 0.5).astype(jnp.int32), 0, levels)
    return q.reshape(H, W)


def run(cfg: Stam3DConfig, s: Stam3DState, n_steps: int) -> Stam3DState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st), s, n_steps)
