"""SPH pair interactions on a flattened, padded cell axis.

Behavioral spec: tau_sph.cu:178-266 (k_density_pressure_cell,
k_forces_cell) + k_integrate (:324-355).  The cell-sharded runners
(sph_sharded.py, sph_spatial.py) lay the particles out as dense fields
(C, K, W + 2*PAD): channel, slot within the cell, flattened cell index.
A neighbour cell is then a static shift of the flattened index by +-1
(x) and +-Gx (y), so each of the 3x3 neighbour visits is one static
slice of the padded window:

  - PAD = Gx + 1 columns on each side keep every shifted slice in bounds;
  - empty slots and pad cells hold a sentinel position (SENTINEL), so the
    r2 < (2h)^2 pair test rejects them with no occupancy mask at all;
  - flat-index wraparound (x edges reading the previous/next row) is
    geometrically rejected by the same r2 test (cells are >= 2h apart).

Both functions take a window of any width and return the W = width -
2*PAD owned columns, so one device computes the whole grid and D
devices each compute a disjoint band of it with the same expressions.
The physics matches solvers/sph.py's cell-dense step to f32 summation
order (the pair sums run in another order).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..ops import cell_dense as cd

__all__ = ["SENTINEL", "grid_geometry", "density", "forces_integrate"]

SENTINEL = -1.0e4  # empty-slot/pad position; far enough that r2 >> (2h)^2


def _alpha(h: float) -> float:
    return 10.0 / (7.0 * math.pi * h * h)


def _w_cubic(r, h: float):
    """Branch-free cubic spline (tau_sph.cu:105-116); safe for sentinel
    distances (polynomials stay finite in f32 at q ~ 1e6)."""
    q = r * (1.0 / h)
    a = _alpha(h)
    q2 = q * q
    inner = a * (1.0 - 1.5 * q2 + 0.75 * q2 * q)
    t = 2.0 - q
    outer = a * 0.25 * t * t * t
    return jnp.where(q < 1.0, inner, jnp.where(q < 2.0, outer, 0.0))


def _grad_scale(r, inv_r, h: float):
    """dW/dq / (h*r) with the reference's validity clamp
    (tau_sph.cu:118-133); multiply by rij to get gradW."""
    q = r * (1.0 / h)
    a = _alpha(h)
    dWdq = jnp.where(
        q < 1.0,
        a * (-3.0 * q + 2.25 * q * q),
        a * (-0.75 * (2.0 - q) ** 2),
    )
    ok = (r > 1e-8) & (r < 2.0 * h)
    return jnp.where(ok, dWdq * (1.0 / h) * inv_r, 0.0)


def grid_geometry(cfg, transpose: bool = False):
    """(grid, PAD): the cell grid and the halo width of the flattened
    layout.  `transpose=True` flips the flat cell order to x-major
    (cid = gx*Gy + gy): the pair math is layout-agnostic (channels stay
    physical x/y and the distance math is symmetric), and x-major slabs
    stay load-balanced for settling flows (sph_spatial.py)."""
    if cfg.use_xsph:
        raise ValueError("the cell-sharded SPH pair path does not "
                         "implement XSPH")
    grid = cfg.grid()
    if transpose:
        grid = cd.DenseGrid(Gx=grid.Gy, Gy=grid.Gx, cell=grid.cell,
                            K=grid.K)
    return grid, grid.Gx + 1


def _offsets(gx: int):
    return [oy * gx + ox for oy in (-1, 0, 1) for ox in (-1, 0, 1)]


def density(cfg, gx: int, pad: int, pos_win):
    """rho and p/rho^2 per slot.  pos_win: (2, K, W + 2*pad) positions;
    returns two (K, W) arrays."""
    W = pos_win.shape[-1] - 2 * pad
    h = cfg.h
    cx = pos_win[0, :, pad:pad + W]
    cy = pos_win[1, :, pad:pad + W]

    rho = jnp.zeros(cx.shape, pos_win.dtype)
    for off in _offsets(gx):
        nx = pos_win[0, :, pad + off:pad + off + W]
        ny = pos_win[1, :, pad + off:pad + off + W]
        dx = cx[:, None, :] - nx[None, :, :]
        dy = cy[:, None, :] - ny[None, :, :]
        r2 = dx * dx + dy * dy
        rho = rho + jnp.sum(_w_cubic(jnp.sqrt(r2), h), axis=1)
    rho = cfg.mass * rho

    # log-density EOS path (tau_sph.cu:207-213)
    s = jnp.log(jnp.maximum(rho, 1e-6))
    rho = jnp.exp(s)
    ratio = rho * (1.0 / cfg.rho0)
    if cfg.gamma_eos == 1.0:
        powed = ratio
    else:
        powed = jnp.exp(cfg.gamma_eos * jnp.log(ratio))
    press = jnp.maximum(
        (cfg.c0 ** 2) * cfg.rho0 * (powed - 1.0) / cfg.gamma_eos, 0.0)
    # p/rho^2 is a per-SLOT quantity: dividing here removes one division
    # per PAIR from the forces pass (the symmetrized pressure gradient
    # only ever uses p_i/rho_i^2 + p_j/rho_j^2)
    rho_safe = jnp.maximum(rho, 1e-30)
    return rho, press / (rho_safe * rho_safe)


def forces_integrate(cfg, gx: int, pad: int, dt, st_win, rp_win):
    """Pressure-gradient + Monaghan viscosity forces fused with the
    symplectic-Euler + restitution-wall integrate.  st_win: (4, K,
    W + 2*pad) x/y/vx/vy; rp_win: (2, K, W + 2*pad) rho and p/rho^2.
    Returns the integrated (4, K, W) slots; sentinel slots move
    harmlessly and are never gathered back."""
    W = st_win.shape[-1] - 2 * pad
    K = st_win.shape[1]
    h = cfg.h
    h2 = h * h
    own = slice(pad, pad + W)
    cx, cy, cvx, cvy = (st_win[c, :, own] for c in range(4))
    rho_i = jnp.maximum(rp_win[0, :, own][:, None, :], 1e-30)
    pterm_i = rp_win[1, :, own][:, None, :]

    ii = jax.lax.broadcasted_iota(jnp.int32, (K, K, 1), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (K, K, 1), 1)
    not_self = ii != jj

    ax = jnp.zeros(cx.shape, st_win.dtype)
    ay = jnp.zeros(cx.shape, st_win.dtype)
    for off in _offsets(gx):
        sl = slice(pad + off, pad + off + W)
        dx = cx[:, None, :] - st_win[0, :, sl][None, :, :]
        dy = cy[:, None, :] - st_win[1, :, sl][None, :, :]
        r2 = dx * dx + dy * dy
        valid = (r2 < (2.0 * h) ** 2) & (r2 > 1e-16)
        if off == 0:
            valid = valid & not_self
        r2s = jnp.maximum(r2, 1e-30)
        inv_r = jax.lax.rsqrt(r2s)
        r = r2s * inv_r
        scale = _grad_scale(r, inv_r, h)

        common = -cfg.mass * (pterm_i + rp_win[1, :, sl][None, :, :])
        if cfg.use_visc:
            vijx = cvx[:, None, :] - st_win[2, :, sl][None, :, :]
            vijy = cvy[:, None, :] - st_win[3, :, sl][None, :, :]
            dot = vijx * dx + vijy * dy
            rho_bar = 0.5 * (rho_i
                             + jnp.maximum(rp_win[0, :, sl][None, :, :],
                                           1e-30))
            # mu/rho_bar folded into one division:
            # pi = -alpha*c0*h*dot / ((r2 + 0.01h^2) * rho_bar)
            pi_ij = jnp.where(
                dot < 0.0,
                (-cfg.visc_alpha * cfg.c0 * h) * dot
                / ((r2 + 0.01 * h2) * rho_bar),
                0.0)
            common = common - cfg.mass * pi_ij

        c = jnp.where(valid, common * scale, 0.0)
        ax = ax + jnp.sum(c * dx, axis=1)
        ay = ay + jnp.sum(c * dy, axis=1)

    if cfg.use_grav:
        ay = ay - cfg.gravity

    # fused k_integrate (tau_sph.cu:324-355)
    e = 0.2
    vx = cvx + ax * dt
    vy = cvy + ay * dt
    x = cx + vx * dt
    y = cy + vy * dt
    lo_x, hi_x = x < 0.0, x > cfg.box_x
    lo_y, hi_y = y < 0.0, y > cfg.box_y
    return jnp.stack([
        jnp.where(lo_x, 0.0, jnp.where(hi_x, cfg.box_x, x)),
        jnp.where(lo_y, 0.0, jnp.where(hi_y, cfg.box_y, y)),
        jnp.where(lo_x | hi_x, -e * vx, vx),
        jnp.where(lo_y | hi_y, -e * vy, vy),
    ])
