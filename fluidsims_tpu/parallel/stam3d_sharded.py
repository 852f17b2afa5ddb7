"""z-slab domain decomposition for the Stam 3-D solver.

Behavioral spec: js_cuda3d.cu — unlike the 2-D solver's zero ring, the
3-D ghost ring is LIVE (k_set_bnd :119-157 writes reflective ghosts and
the Jacobi ping-pong alternates the ring between x's originals and the
zeroed scratch, lin_solve :297-313).  The sharded operators therefore
carry that ring-parity logic across z-slabs:

* `_lin_solve_sharded` — K-deep z-halo + K fused Jacobi iterations per
  ppermute exchange; ring values (saved from the entry buffer) are
  re-applied by global iteration parity each sweep, which cuts every
  dependency chain at the true domain faces, so edge devices need no
  special casing and slab-edge corruption is confined to the K cropped
  halo slices.  Bit-identical to solvers.stam3d._lin_solve (even iters).

* `_advect_sharded` — the dense-shift trilinear advection
  (solvers.stam3d._advect_dense) on a z-window of K halo slices,
  identical loop order and weights; z-backtraces are clipped to the
  global domain by the same [0.5, n+0.5] clamp, so all weight-carrying
  reads stay inside the exchanged window.

* `_set_bnd_sharded` — mask-select form of set_bnd with single-slice
  ppermute shifts for the z faces (robust even when the two boundary
  slices land on different devices).

The (n+2)^3 arrays are padded along z to a device-divisible Zp; padded
slices carry finite junk that can never reach a real cell: every z
dependency chain passes through the gz = n+1 ghost face, which the ring
parity (Jacobi), the ring passthrough (advection), or set_bnd rewrites
before the junk can cross.

Equivalence vs the single-chip step is gated in
tests/test_stam_sharded.py (bitwise per operator at D=2, few-ulp
tolerance elsewhere — XLA FMA contraction varies with local shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import stam3d as s3

__all__ = ["shard_state", "unshard_state", "make_sharded_step",
           "make_sharded_run", "padded_z"]


def padded_z(n: int, n_dev: int) -> int:
    """z extent after padding (n+2) up to a device-divisible size."""
    np_ = n + 2
    return -(-np_ // n_dev) * n_dev


def _exchange_z(f, halo: int, axis: str, n_dev: int):
    """Extend a local (B, Np, Np) slab with `halo` z-slices from each slab
    neighbor; unpaired edges receive ppermute's zero fill (finite, and
    unreachable past the domain-face ring)."""
    lower = lax.ppermute(f[-halo:], axis,
                         perm=[(i, i + 1) for i in range(n_dev - 1)])
    upper = lax.ppermute(f[:halo], axis,
                         perm=[(i + 1, i) for i in range(n_dev - 1)])
    return jnp.concatenate([lower, f, upper], axis=0)


def _ring_mask(z_off, W, Np, extra_lo=0):
    """Domain-face ring mask for a local z-window of W slices starting at
    global z = z_off - extra_lo."""
    gz = (jax.lax.broadcasted_iota(jnp.int32, (W, 1, 1), 0)
          + z_off - extra_lo)
    gy = jax.lax.broadcasted_iota(jnp.int32, (1, Np, 1), 1)
    gx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, Np), 2)
    ring = ((gz == 0) | (gz == Np - 1) | (gy == 0) | (gy == Np - 1)
            | (gx == 0) | (gx == Np - 1))
    return ring, gz, gy, gx


def _lin_solve_sharded(x, x0, a, c, iters: int, halo_k: int, Np: int,
                       z_off, axis: str, n_dev: int):
    """Ring-parity Jacobi, bitwise equal to solvers.stam3d._lin_solve for
    even `iters`, with ceil(iters/halo_k) halo exchanges."""
    if iters % 2:
        raise ValueError("sharded stam3d lin_solve requires even iters")
    B = x.shape[0]
    ring_src = x  # entry buffer: its ring alternates with zeros (parity)
    cur = x
    done = 0
    # x0 and the entry buffer's ring are loop-invariant: exchange them
    # once per distinct extension width (at most two) instead of per
    # round — identical values, fewer ppermutes
    invariants = {}
    while done < iters:
        kb = min(halo_k, iters - done)
        if kb not in invariants:
            x0e_c = _exchange_z(x0, kb, axis, n_dev)
            re_c = _exchange_z(ring_src, kb, axis, n_dev)
            ring_c, _, _, _ = _ring_mask(z_off, B + 2 * kb, Np, extra_lo=kb)
            invariants[kb] = (x0e_c[1:-1, 1:-1, 1:-1], ring_c,
                              jnp.where(ring_c, re_c, 0.0))
        x0i, ring, ringv = invariants[kb]
        ce = _exchange_z(cur, kb, axis, n_dev)
        for tt in range(kb):
            # the ghost ring read at global iteration `it`: x's originals
            # when even, the zeroed scratch's when odd (lin_solve ping-pong)
            if (done + tt) % 2 == 0:
                ce = jnp.where(ring, ringv, ce)
            else:
                ce = jnp.where(ring, 0.0, ce)
            ce = jnp.pad((x0i + a * s3._sum6(ce)) / c, 1)
        cur = ce[kb:-kb]
        done += kb
    # an even total lands in the x buffer: x's ring survives on the result
    ringl, _, _, _ = _ring_mask(z_off, B, Np)
    return jnp.where(ringl, ring_src, cur)


def _advect_sharded(cfg, q0, u, v, w, Np: int, z_off, axis: str,
                    n_dev: int):
    """Dense-shift trilinear advection (solvers.stam3d._advect_dense) on a
    z-slab: identical weights and summation order, z-window of K halo
    slices (offsets -K..K; the K+1 offset's hat weight is identically
    zero under the [-K, K] clip).  Ring and padded slices pass q0
    through unchanged."""
    n = cfg.n
    K = cfg.advect_k
    dt_ = cfg.dt
    B = q0.shape[0]
    dtype = q0.dtype

    qe = _exchange_z(q0, K, axis, n_dev)              # (B + 2K, Np, Np)
    qp = jnp.pad(qe, ((0, 0), (K, K), (K, K)), mode="edge")

    idx = jnp.arange(1, n + 1, dtype=dtype)
    I = idx[None, None, :]
    J = idx[None, :, None]
    gz = jax.lax.broadcasted_iota(jnp.int32, (B, 1, 1), 0) + z_off
    Kz = gz.astype(dtype)

    ub = u[:, 1:-1, 1:-1]
    vb = v[:, 1:-1, 1:-1]
    wb = w[:, 1:-1, 1:-1]

    def backtrace(base, vel):
        x = jnp.clip(base - dt_ * vel, 0.5, n + 0.5)
        return base + jnp.clip(x - base, -K, K)

    x = backtrace(I, ub)
    y = backtrace(J, vb)
    z = backtrace(Kz, wb)

    def hat(pos, base, o):
        return jnp.maximum(0.0, 1.0 - jnp.abs(pos - (base + o)))

    offs = list(range(-K, K + 1))
    wx = [hat(x, I, o) for o in offs]
    wy = [hat(y, J, o) for o in offs]
    wz = [hat(z, Kz, o) for o in offs]

    acc = jnp.zeros((B, n, n), dtype)
    for iz, oz in enumerate(offs):
        for iy, oy in enumerate(offs):
            wzy = wz[iz] * wy[iy]
            for ix, ox in enumerate(offs):
                # local row l holds global z_off + l; source row at offset
                # oz sits at window index l + K + oz
                sl = qp[K + oz: K + oz + B,
                        1 + K + oy: 1 + K + oy + n,
                        1 + K + ox: 1 + K + ox + n]
                acc = acc + (wzy * wx[ix]) * sl
    accf = jnp.pad(acc, ((0, 0), (1, 1), (1, 1)))
    interior = ((gz >= 1) & (gz <= Np - 2)
                & (jax.lax.broadcasted_iota(jnp.int32, (1, Np, 1), 1) >= 1)
                & (jax.lax.broadcasted_iota(jnp.int32, (1, Np, 1), 1) <= Np - 2)
                & (jax.lax.broadcasted_iota(jnp.int32, (1, 1, Np), 2) >= 1)
                & (jax.lax.broadcasted_iota(jnp.int32, (1, 1, Np), 2) <= Np - 2))
    return jnp.where(interior, accf, q0)


def _set_bnd_sharded(u, v, w, d, Np: int, z_off, axis: str, n_dev: int):
    """Reflective velocity walls + density ghost copy (k_set_bnd,
    js_cuda3d.cu:119-157) in one mask-select pass per field, with
    single-slice ppermute shifts so the z faces work at any slab split."""
    B = u.shape[0]
    ring, gz, gy, gx = _ring_mask(z_off, B, Np)
    int_z = (gz >= 1) & (gz <= Np - 2)
    int_y = (gy >= 1) & (gy <= Np - 2)
    int_x = (gx >= 1) & (gx <= Np - 2)
    signs = ((-1.0, 1.0, 1.0), (1.0, -1.0, 1.0), (1.0, 1.0, -1.0),
             (1.0, 1.0, 1.0))
    outs = []
    for g, (sx, sy, sz) in zip((u, v, w, d), signs):
        out = g
        out = jnp.where((gx == 0) & int_y & int_z, sx * g[:, :, 1:2], out)
        out = jnp.where((gx == Np - 1) & int_y & int_z,
                        sx * g[:, :, Np - 2:Np - 1], out)
        out = jnp.where((gy == 0) & int_x & int_z, sy * g[:, 1:2, :], out)
        out = jnp.where((gy == Np - 1) & int_x & int_z,
                        sy * g[:, Np - 2:Np - 1, :], out)
        # z faces: the neighbor slice may live on the adjacent device
        nxt = lax.ppermute(g[:1], axis,
                           perm=[(i + 1, i) for i in range(n_dev - 1)])
        prv = lax.ppermute(g[-1:], axis,
                           perm=[(i, i + 1) for i in range(n_dev - 1)])
        sh_up = jnp.concatenate([g[1:], nxt], axis=0)    # value at gz+1
        sh_dn = jnp.concatenate([prv, g[:-1]], axis=0)   # value at gz-1
        out = jnp.where((gz == 0) & int_x & int_y, sz * sh_up, out)
        out = jnp.where((gz == Np - 1) & int_x & int_y, sz * sh_dn, out)
        outs.append(out)
    return tuple(outs)


def _project_sharded(cfg, u, v, w, p_init, lin_solve, Np: int, z_off,
                     axis: str, n_dev: int):
    """div -> Jacobi Poisson -> gradient subtract (project,
    js_cuda3d.cu:316-322) with halo-1 z exchanges."""
    B = u.shape[0]
    ring, gz, gy, gx = _ring_mask(z_off, B, Np)
    interior = ((gz >= 1) & (gz <= Np - 2) & (gy >= 1) & (gy <= Np - 2)
                & (gx >= 1) & (gx <= Np - 2))

    we = _exchange_z(w, 1, axis, n_dev)
    div_i = -0.5 * (
        (u[:, 1:-1, 2:] - u[:, 1:-1, :-2])
        + (v[:, 2:, 1:-1] - v[:, :-2, 1:-1])
        + (we[2:, 1:-1, 1:-1] - we[:-2, 1:-1, 1:-1])
    )
    div = jnp.where(interior,
                    jnp.pad(div_i, ((0, 0), (1, 1), (1, 1))),
                    jnp.zeros((), u.dtype))
    p = jnp.where(interior, jnp.zeros((), u.dtype), p_init)
    p = lin_solve(p, div)
    pe = _exchange_z(p, 1, axis, n_dev)
    u = jnp.where(interior, u - 0.5 * jnp.pad(
        p[:, 1:-1, 2:] - p[:, 1:-1, :-2], ((0, 0), (1, 1), (1, 1))), u)
    v = jnp.where(interior, v - 0.5 * jnp.pad(
        p[:, 2:, 1:-1] - p[:, :-2, 1:-1], ((0, 0), (1, 1), (1, 1))), v)
    w = jnp.where(interior, w - 0.5 * jnp.pad(
        pe[2:, 1:-1, 1:-1] - pe[:-2, 1:-1, 1:-1], ((0, 0), (1, 1), (1, 1))),
        w)
    return u, v, w, p


def _add_source_sharded(cfg, u, v, w, d, step_idx, Np: int, z_off):
    """Decay + orbiting swirl source (k_decay/k_add_source3d,
    js_cuda3d.cu:91-117) with global z coordinates."""
    n = cfg.n
    B = u.shape[0]
    dt = u.dtype
    ring, gz, gy, gx = _ring_mask(z_off, B, Np)
    interior = ((gz >= 1) & (gz <= Np - 2) & (gy >= 1) & (gy <= Np - 2)
                & (gx >= 1) & (gx <= Np - 2))
    no4 = n / 4.0
    t = cfg.src_freq * step_idx.astype(dt)
    fi = gx.astype(dt)
    fj = gy.astype(dt)
    fk = gz.astype(dt)
    dx = fi - no4 * (1.0 + jnp.cos(t))
    dy = fj - no4 * (1.0 + jnp.sin(t))
    dz = fk - no4 * (1.0 + jnp.sin(t))
    r2 = dx * dx + dy * dy + dz * dz
    inside = interior & (r2 < n)
    r = jnp.sqrt(r2) + 1e-7
    d = jnp.where(interior, d * cfg.decay, d)
    d = jnp.where(inside, d + cfg.src_gain * jnp.exp(-r2 / n), d)
    u = jnp.where(inside, u + dz / r, u)
    v = jnp.where(inside, v + dy / r, v)
    w = jnp.where(inside, w + dx / r, w)
    return u, v, w, d


def shard_state(s: s3.Stam3DState, mesh: Mesh, axis: str = "x"):
    """Pad the (n+2)^3 fields along z to a device-divisible extent and
    place them as z-slabs; step_idx replicated."""
    n_dev = mesh.shape[axis]

    def place(a):
        if a.ndim == 3:
            zp = padded_z(a.shape[0] - 2, n_dev)
            a = jnp.pad(a, ((0, zp - a.shape[0]), (0, 0), (0, 0)))
            return jax.device_put(a, NamedSharding(mesh, P(axis, None, None)))
        return jax.device_put(a, NamedSharding(mesh, P()))

    return jax.tree.map(place, s)


def unshard_state(s: s3.Stam3DState, n: int) -> s3.Stam3DState:
    """Crop the z padding back to (n+2)^3."""
    return jax.tree.map(
        lambda a: a[: n + 2] if a.ndim == 3 else a, s)


def make_sharded_step(cfg: s3.Stam3DConfig, mesh: Mesh, halo_k: int = 4,
                      axis: str = "x"):
    """Build step(state) -> state over z-slab-sharded Stam3DState fields
    (the same sequence as solvers.stam3d.step)."""
    n_dev = mesh.shape[axis]
    Np = cfg.n + 2
    Zp = padded_z(cfg.n, n_dev)
    B = Zp // n_dev
    if cfg.jacobi_iters % 2:
        raise ValueError("sharded stam3d requires even jacobi_iters")
    if not 1 <= halo_k <= B:
        raise ValueError("halo_k must be in [1, Zp/n_devices]")
    if cfg.advect_k < 1:
        raise ValueError("sharded stam3d requires the dense advection "
                         "(advect_k >= 1)")
    if cfg.advect_k + 1 > B:
        raise ValueError("advect_k + 1 must be <= Zp/n_devices")

    def body(u, v, w, u0, v0, w0, d, d0, step_idx):
        z_off = lax.axis_index(axis) * B

        def lin_solve(x, b, a, c):
            return _lin_solve_sharded(x, b, a, c, cfg.jacobi_iters,
                                      halo_k, Np, z_off, axis, n_dev)

        def diffuse(x, x0f, coeff):
            a = cfg.dt * coeff * cfg.n * cfg.n
            return lin_solve(x, x0f, a, 1.0 + 6.0 * a)

        def advect(q0, uu, vv, ww):
            return _advect_sharded(cfg, q0, uu, vv, ww, Np, z_off,
                                   axis, n_dev)

        def set_bnd(uu, vv, ww, dd):
            return _set_bnd_sharded(uu, vv, ww, dd, Np, z_off, axis, n_dev)

        def project(uu, vv, ww, p_init):
            return _project_sharded(
                cfg, uu, vv, ww, p_init,
                lambda x, b: lin_solve(x, b, 1.0, 6.0),
                Np, z_off, axis, n_dev)

        u, v, w, d = _add_source_sharded(cfg, u, v, w, d, step_idx, Np,
                                         z_off)

        # vel_step
        u0 = diffuse(u0, u, cfg.visc)
        v0 = diffuse(v0, v, cfg.visc)
        w0 = diffuse(w0, w, cfg.visc)
        u0, v0, w0, d = set_bnd(u0, v0, w0, d)
        u0, v0, w0, p = project(u0, v0, w0, jnp.zeros_like(u0))
        u0, v0, w0, d = set_bnd(u0, v0, w0, d)
        u = advect(u0, u0, v0, w0)
        v = advect(v0, u0, v0, w0)
        w = advect(w0, u0, v0, w0)
        u, v, w, d = set_bnd(u, v, w, d)
        u, v, w, p = project(u, v, w, p)
        u, v, w, d = set_bnd(u, v, w, d)

        # dens_step
        d0 = diffuse(d0, d, cfg.diff)
        u, v, w, d0 = set_bnd(u, v, w, d0)
        d = advect(d0, u, v, w)
        u, v, w, d = set_bnd(u, v, w, d)

        return (u, v, w, u0, v0, w0, d, d0,
                (step_idx + 1).astype(step_idx.dtype))

    fspec = P(axis, None, None)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(fspec,) * 8 + (P(),),
        out_specs=(fspec,) * 8 + (P(),),
        check_vma=False,
    )

    def step(s: s3.Stam3DState) -> s3.Stam3DState:
        u, v, w, u0, v0, w0, d, d0, si = sharded(
            s.u, s.v, s.w, s.u0, s.v0, s.w0, s.d, s.d0, s.step_idx)
        return s3.Stam3DState(u=u, v=v, w=w, u0=u0, v0=v0, w0=w0,
                              d=d, d0=d0, step_idx=si)

    return step


def make_sharded_run(cfg: s3.Stam3DConfig, mesh: Mesh, n_steps: int,
                     halo_k: int = 4, axis: str = "x"):
    """Jitted multi-step runner over the sharded step."""
    step = make_sharded_step(cfg, mesh, halo_k, axis)

    @jax.jit
    def run(s):
        def one(carry, _):
            return step(carry), None

        out, _ = lax.scan(one, s, None, length=n_steps)
        return out

    return run
