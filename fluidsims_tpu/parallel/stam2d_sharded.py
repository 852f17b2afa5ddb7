"""x-slab domain decomposition for the Stam 2-D solver.

Behavioral spec: js_cuda.cu — the solver's ghost ring is a ZERO halo
that is memset once and never written (js_cuda.cu:317-323; the
solver realizes it with jnp.pad, solvers/stam2d.py).  That makes the
non-periodic slab exchange trivial: `lax.ppermute` with a non-wrapping
permutation fills unpaired edges with zeros, which IS the reference's
ghost ring — edge devices need no special casing at all.

Communication-avoiding Jacobi (same idea as the K-deep periodic halos in
parallel/periodic_sharded.py): exchange `halo_k` columns once, then run
`halo_k` fused Jacobi iterations on the extended slab.  Slab-edge
corruption creeps one column per iteration, so after K iterations it has
reached exactly the K ghost columns, which are cropped — a 40-iteration
lin_solve (js_cuda.cu:143-158) pays ceil(40/K) exchanges instead of 40.

The semi-Lagrangian advection (k_adv, js_cuda.cu:82-103) back-traces in
eta-space; its column reach is bounded by `advect_halo` ghost columns
per shard: backtraces farther than the halo are clamped to the halo
edge and counted (psum'd into state.ovf), never silently.  Rows are
fully local (the slab is x-only), so the row direction stays exact
everywhere.

Every interior value is BITWISE equal to the single-chip step
(identical expression trees per cell; proven in
tests/test_stam_sharded.py) whenever no advection clamp fires.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.gather import gather2d
from ..solvers import stam2d as s2

__all__ = ["shard_state", "make_sharded_step", "make_sharded_run"]


def _exchange_x(f, halo: int, axis: str, n_dev: int):
    """Extend a local (n, n_loc) slab with `halo` columns from each slab
    neighbor.  Non-periodic: the leftmost/rightmost devices receive
    ppermute's zero fill, which equals the solver's zero ghost ring."""
    left = lax.ppermute(f[..., -halo:], axis,
                        perm=[(i, i + 1) for i in range(n_dev - 1)])
    right = lax.ppermute(f[..., :halo], axis,
                         perm=[(i + 1, i) for i in range(n_dev - 1)])
    return jnp.concatenate([left, f, right], axis=-1)


def _lin_solve_sharded(x, x0, a, c, iters: int, halo_k: int,
                       axis: str, n_dev: int):
    """Jacobi x <- (x0 + a*sum4(x))/c, bitwise equal to
    solvers.stam2d._lin_solve, with ceil(iters/halo_k) exchanges.

    At the two domain-edge devices the halo columns lie OUTSIDE the
    global domain; the single-chip solve re-pads a fresh zero ring every
    iteration, so those columns are pinned to zero here (they would
    otherwise evolve like fluid cells and leak into the edge stencil)."""
    n_loc = x.shape[-1]
    col0 = lax.axis_index(axis) * n_loc
    n = n_loc * n_dev
    done = 0
    # x0 is loop-invariant: exchange it once per distinct extension width
    # (at most two widths: halo_k and the final remainder) instead of per
    # round — identical values, ceil(iters/halo_k)-1 fewer ppermute pairs
    invariants = {}
    while done < iters:
        kb = min(halo_k, iters - done)
        if kb not in invariants:
            ge = col0 + jnp.arange(-kb, n_loc + kb)  # global interior cols
            invariants[kb] = (_exchange_x(x0, kb, axis, n_dev),
                              ((ge >= 0) & (ge < n))[None, :])
        x0e, inb = invariants[kb]
        xe = _exchange_x(x, kb, axis, n_dev)
        for _ in range(kb):
            xe = jnp.where(inb, (x0e + a * s2._sum4(xe)) / c, 0.0)
        x = xe[..., kb:-kb]
        done += kb
    return x


def _metric(cfg):
    """Per-axis eta coordinates and physical positions, computed under jit
    so XLA constant-folds them EXACTLY as it does inside the single-chip
    step (a runtime exp from a traced axis_index differs from the folded
    exp by ~1 ulp, which breaks bitwise equivalence)."""

    @jax.jit
    def build():
        deta = (cfg.eta_max - cfg.eta_min) / cfg.n
        idx = jnp.arange(1, cfg.n + 1, dtype=cfg.jax_dtype)
        eta = cfg.eta_min + (idx - 0.5) * deta
        return eta, cfg.x0 * jnp.exp(eta), cfg.y0 * jnp.exp(eta)

    return build()


def _advect_sharded(cfg, q0, uu, vv, halo: int, col_off, eta_loc, xp_loc,
                    eta_full, yp_full, axis: str, n_dev: int):
    """Semi-Lagrangian back-trace (k_adv) on a slab: rows exact, column
    reach clamped to `halo` ghost columns.  Returns (q, clamped_count)."""
    n = cfg.n
    n_loc = q0.shape[-1]
    dt = q0.dtype
    deta = (cfg.eta_max - cfg.eta_min) / n
    eta_x = eta_loc
    eta_y = eta_full
    xp = xp_loc[None, :]
    yp = yp_full[:, None]

    bx = eta_x[None, :] - cfg.dt * uu / xp
    by = eta_y[:, None] - cfg.dt * vv / yp
    sarr = jnp.clip((bx - cfg.eta_min) / deta + 0.5, 0.5, n + 0.5)
    tarr = jnp.clip((by - cfg.eta_min) / deta + 0.5, 0.5, n + 0.5)

    i0 = jnp.floor(sarr).astype(jnp.int32)   # global, in [0, n]
    j0 = jnp.floor(tarr).astype(jnp.int32)
    # local extended slab covers global IX columns [lo, lo + n_loc + 2h - 1]
    lo = col_off + 1 - halo
    i0c = jnp.clip(i0, lo, lo + n_loc + 2 * halo - 2)  # i0c + 1 in range
    clamped = jnp.sum((i0c != i0).astype(jnp.int32))
    s1 = jnp.clip(sarr - i0c.astype(dt), 0.0, 1.0)  # exact when unclamped
    t1 = tarr - j0.astype(dt)
    s0 = 1.0 - s1
    t0 = 1.0 - t1

    qe = _exchange_x(q0, halo, axis, n_dev)     # zero ring at domain edges
    qp = jnp.pad(qe, ((1, 1), (0, 0)))          # zero ring rows
    li0 = i0c - lo
    q00 = gather2d(qp, j0, li0)
    q01 = gather2d(qp, j0 + 1, li0)
    q10 = gather2d(qp, j0, li0 + 1)
    q11 = gather2d(qp, j0 + 1, li0 + 1)
    q = s0 * (t0 * q00 + t1 * q01) + s1 * (t0 * q10 + t1 * q11)
    return q, clamped


def _project_sharded(cfg, uu, vv, dx_loc, dy_w, lin_solve, axis: str,
                     n_dev: int):
    """div -> Jacobi Poisson -> gradient subtract (k_div/k_proj,
    js_cuda.cu:105-124), slab form with halo-1 exchanges."""
    # reciprocal-multiply exactly as solvers.stam2d._project (IEEE division
    # is correctly rounded, so the runtime 1/w here equals the single-chip
    # program's constant-folded one bit-for-bit)
    inv_dx = 1.0 / dx_loc
    inv_dy = 1.0 / dy_w
    ue = _exchange_x(uu, 1, axis, n_dev)
    pv = jnp.pad(vv, ((1, 1), (0, 0)))
    div = -0.5 * (
        (ue[:, 2:] - ue[:, :-2]) * inv_dx[None, :]
        + (pv[2:, :] - pv[:-2, :]) * inv_dy[:, None]
    )
    p = lin_solve(jnp.zeros_like(div), div, 1.0, 4.0)
    pe = _exchange_x(p, 1, axis, n_dev)
    pp = jnp.pad(pe, ((1, 1), (0, 0)))
    uu = uu - 0.5 * dx_loc[None, :] * (pp[1:-1, 2:] - pp[1:-1, :-2])
    vv = vv - 0.5 * dy_w[:, None] * (pp[2:, 1:-1] - pp[:-2, 1:-1])
    return uu, vv


def _add_source_sharded(cfg, u, v, d, step_idx, col_off):
    """Orbiting swirl source (k_add_source, js_cuda.cu:126-140) with
    global column coordinates."""
    n = cfg.n
    n_loc = u.shape[-1]
    dt = u.dtype
    ang = step_idx.astype(dt) * 0.015
    cx = n // 2 + jnp.trunc((n / 4) * jnp.cos(ang)).astype(jnp.int32)
    cy = n // 2 + jnp.trunc((n / 4) * jnp.sin(ang)).astype(jnp.int32)
    R = 3.0
    swirl = 0.6
    amp = 0.5 + 0.4 * jnp.sin(step_idx.astype(dt) * 0.02)

    gi = col_off + jnp.arange(1, n_loc + 1)
    j = jnp.arange(1, n + 1)[:, None]
    dx = (gi[None, :] - cx).astype(dt)
    dy = (j - cy).astype(dt)
    r2 = dx * dx + dy * dy
    r = jnp.sqrt(r2) + 1e-6
    inside = r2 < R * R
    d = d + jnp.where(inside, amp * jnp.exp(-r2 / (R * R)), 0.0)
    u = u + jnp.where(inside, -swirl * dy / r, 0.0)
    v = v + jnp.where(inside, swirl * dx / r, 0.0)
    return u, v, d


def shard_state(s: s2.Stam2DState, mesh: Mesh, axis: str = "x"):
    """Place the (n, n) fields as x-slabs; scalars replicated."""

    def place(a):
        spec = P(None, axis) if a.ndim == 2 else P()
        return jax.device_put(a, NamedSharding(mesh, spec))

    return jax.tree.map(place, s)


def make_sharded_step(cfg: s2.Stam2DConfig, mesh: Mesh, halo_k: int = 8,
                      advect_halo: int | None = None, axis: str = "x"):
    """Build step(state) -> state over x-slab-sharded Stam2DState fields.

    `halo_k` = Jacobi iterations fused per halo exchange (<= n/n_dev).
    `advect_halo` = ghost columns for the back-trace (default
    min(advect_band, n/n_dev)); larger = exact for faster flows.
    """
    n_dev = mesh.shape[axis]
    if cfg.n % n_dev:
        raise ValueError(f"n={cfg.n} must divide over {n_dev} devices")
    n_loc = cfg.n // n_dev
    if advect_halo is None:
        advect_halo = min(cfg.advect_band, n_loc)
    if not (1 <= halo_k <= n_loc and 1 <= advect_halo <= n_loc):
        raise ValueError("halos must be in [1, n/n_devices]")
    import numpy as np

    widths_np = np.asarray(s2._cell_widths(cfg))
    dx_full = jnp.asarray(widths_np, cfg.jax_dtype)
    eta_full, xp_full, yp_full = _metric(cfg)

    def body(u, v, u0, v0, d, d0, step_idx, ovf, dx_loc, eta_loc, xp_loc,
             eta_all, yp_all):
        col_off = lax.axis_index(axis) * n_loc
        dy_w = jnp.asarray(widths_np, cfg.jax_dtype)  # rows: full axis

        def lin_solve(x, b, a, c):
            return _lin_solve_sharded(x, b, a, c, cfg.jacobi_iters,
                                      halo_k, axis, n_dev)

        def diffuse(x, x0f, coeff):
            a = cfg.dt * coeff * cfg.n * cfg.n
            return lin_solve(x, x0f, a, 1.0 + 4.0 * a)

        clamp_total = jnp.asarray(0, jnp.int32)

        def advect(q0, uu, vv):
            nonlocal clamp_total
            q, c = _advect_sharded(cfg, q0, uu, vv, advect_halo, col_off,
                                   eta_loc, xp_loc, eta_all, yp_all,
                                   axis, n_dev)
            clamp_total = clamp_total + c
            return q

        d = d * cfg.dens_decay
        u, v, d = _add_source_sharded(cfg, u, v, d, step_idx, col_off)

        # vel_step (js_cuda.cu:165-182)
        u0 = diffuse(u0, u, cfg.visc)
        v0 = diffuse(v0, v, cfg.visc)
        u0, v0 = _project_sharded(cfg, u0, v0, dx_loc, dy_w, lin_solve,
                                  axis, n_dev)
        u = advect(u0, u0, v0)
        v = advect(v0, u0, v0)
        u, v = _project_sharded(cfg, u, v, dx_loc, dy_w, lin_solve,
                                axis, n_dev)

        # dens_step (js_cuda.cu:184-191)
        d0 = diffuse(d0, d, cfg.diff)
        d = advect(d0, u, v)

        ovf = (ovf + lax.psum(clamp_total, axis)).astype(ovf.dtype)
        return u, v, u0, v0, d, d0, (step_idx + 1).astype(step_idx.dtype), ovf

    fspec = P(None, axis)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(fspec,) * 6 + (P(), P(), P(axis), P(axis), P(axis),
                                 P(), P()),
        out_specs=(fspec,) * 6 + (P(), P()),
        check_vma=False,
    )

    def step(s: s2.Stam2DState) -> s2.Stam2DState:
        u, v, u0, v0, d, d0, si, ovf = sharded(
            s.u, s.v, s.u0, s.v0, s.d, s.d0, s.step_idx, s.ovf, dx_full,
            eta_full, xp_full, eta_full, yp_full)
        return s2.Stam2DState(u=u, v=v, u0=u0, v0=v0, d=d, d0=d0,
                              step_idx=si, ovf=ovf)

    return step


def make_sharded_run(cfg: s2.Stam2DConfig, mesh: Mesh, n_steps: int,
                     halo_k: int = 8, advect_halo: int | None = None,
                     axis: str = "x"):
    """Jitted multi-step runner over the sharded step."""
    step = make_sharded_step(cfg, mesh, halo_k, advect_halo, axis)

    @jax.jit
    def run(s):
        def one(carry, _):
            return step(carry), None

        out, _ = lax.scan(one, s, None, length=n_steps)
        return out

    return run
