"""2-D compressible Euler primitives (ideal gas), vectorized over grids.

Behavioral spec: the device math of the flagship reference solver —
cons↔prim with positivity floors (tau_hypersonic_cuda.cu:143-174), axis
fluxes (:194-215), wall ghost states (:262-264), inflow state (:230-238),
MUSCL face reconstruction with positivity contraction (:373-425) and the
MUSCL-Hancock half-step predictor (:443-471).

All functions broadcast over arbitrary leading shapes: fields are plain
jnp arrays bundled in `Cons` / `Prim` NamedTuples (JAX pytrees), so one code
path serves scalars (unit tests), whole grids, and face arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "EPS_RHO",
    "EPS_P",
    "Cons",
    "Prim",
    "cons_to_prim",
    "prim_to_cons",
    "sound_speed",
    "flux",
    "wall_ghost",
    "inflow_prim",
    "c_add",
    "c_sub",
    "c_scale",
    "c_where",
    "p_where",
    "reconstruct_faces",
    "enforce_positive_faces",
    "half_step_predict",
    "clamp_prim",
]

# Positivity floors (tau_hypersonic_cuda.cu:32-33). Representable in float32
# (min normal ~1.2e-38).
EPS_RHO = 1e-25
EPS_P = 1e-25


class Cons(NamedTuple):
    """Conserved state (rho, rho*u, rho*v, total energy)."""

    rho: jnp.ndarray
    mx: jnp.ndarray
    my: jnp.ndarray
    E: jnp.ndarray


class Prim(NamedTuple):
    """Primitive state (rho, u, v, p)."""

    rho: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    p: jnp.ndarray


def _tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


def c_add(a: Cons, b: Cons) -> Cons:
    return _tmap(jnp.add, a, b)


def c_sub(a: Cons, b: Cons) -> Cons:
    return _tmap(jnp.subtract, a, b)


def c_scale(s, a: Cons) -> Cons:
    return _tmap(lambda x: s * x, a)


def c_where(sel, a: Cons, b: Cons) -> Cons:
    return _tmap(lambda x, y: jnp.where(sel, x, y), a, b)


def p_where(sel, a: Prim, b: Prim) -> Prim:
    return _tmap(lambda x, y: jnp.where(sel, x, y), a, b)


def cons_to_prim(c: Cons, gamma: float) -> Prim:
    rho = jnp.maximum(c.rho, EPS_RHO)
    inv = 1.0 / rho
    u = c.mx * inv
    v = c.my * inv
    kin = 0.5 * rho * (u * u + v * v)
    eint = c.E - kin
    p = (gamma - 1.0) * jnp.maximum(eint, EPS_P)
    return Prim(rho=rho, u=u, v=v, p=p)


def prim_to_cons(p: Prim, gamma: float) -> Cons:
    rho = jnp.maximum(p.rho, EPS_RHO)
    pr = jnp.maximum(p.p, EPS_P)
    return Cons(
        rho=rho,
        mx=rho * p.u,
        my=rho * p.v,
        E=pr / (gamma - 1.0) + 0.5 * rho * (p.u * p.u + p.v * p.v),
    )


def sound_speed(p: Prim, gamma: float):
    return jnp.sqrt(gamma * jnp.maximum(p.p, EPS_P) / jnp.maximum(p.rho, EPS_RHO))


def flux(c: Cons, gamma: float, axis: int) -> Cons:
    """Physical flux along axis (0 = x, 1 = y)."""
    p = cons_to_prim(c, gamma)
    if axis == 0:
        un = p.u
        return Cons(rho=c.mx, mx=c.mx * un + p.p, my=c.my * un, E=(c.E + p.p) * un)
    un = p.v
    return Cons(rho=c.my, mx=c.mx * un, my=c.my * un + p.p, E=(c.E + p.p) * un)


def wall_ghost(inside: Prim) -> Prim:
    """No-slip wall ghost: negate both velocity components
    (tau_hypersonic_cuda.cu:262-264)."""
    return Prim(rho=inside.rho, u=-inside.u, v=-inside.v, p=inside.p)


def inflow_prim(gamma: float, mach: float, dtype=jnp.float32) -> Prim:
    """Nondimensional supersonic inflow: rho=1, p=1, u=M*a, v=0."""
    import math

    a = math.sqrt(gamma)
    return Prim(
        rho=jnp.asarray(1.0, dtype),
        u=jnp.asarray(mach * a, dtype),
        v=jnp.asarray(0.0, dtype),
        p=jnp.asarray(1.0, dtype),
    )


def clamp_prim(q: Prim) -> Prim:
    return Prim(
        rho=jnp.maximum(q.rho, EPS_RHO), u=q.u, v=q.v, p=jnp.maximum(q.p, EPS_P)
    )


def enforce_positive_faces(qm: Prim, qc: Prim, qp: Prim) -> tuple[Prim, Prim]:
    """Contract reconstructed face states toward the cell center until both
    are positive (8 fixed iterations; tau_hypersonic_cuda.cu:373-398).

    The scalar loop with early-exit becomes 8 unrolled masked-blend rounds —
    cells already valid are left untouched by the `where`.  (Gating the
    rounds behind a scalar `any(bad)` cond — the reference's early-exit at
    block granularity — is not done: separately-compiled cond branches are
    not guaranteed bit-identical to the inline dataflow.)
    """

    def blend(a: Prim, c: Prim, sel) -> Prim:
        half = Prim(
            rho=0.5 * (a.rho + c.rho),
            u=0.5 * (a.u + c.u),
            v=0.5 * (a.v + c.v),
            p=0.5 * (a.p + c.p),
        )
        return p_where(sel, half, a)

    for _ in range(8):
        bad = (
            (qm.rho <= EPS_RHO)
            | (qp.rho <= EPS_RHO)
            | (qm.p <= EPS_P)
            | (qp.p <= EPS_P)
        )
        qm = blend(qm, qc, bad)
        qp = blend(qp, qc, bad)

    return clamp_prim(qm), clamp_prim(qp)


def reconstruct_faces(qm: Prim, qc: Prim, qp: Prim) -> tuple[Prim, Prim]:
    """MC-limited linear reconstruction to the two faces of a cell
    (tau_hypersonic_cuda.cu:400-425). Returns (qL, qR) = (low face, high face).
    """
    from .limiters import mc_limiter

    def slope(m, c, p):
        return mc_limiter(c - m, 0.5 * (p - m), p - c)

    s = Prim(
        rho=slope(qm.rho, qc.rho, qp.rho),
        u=slope(qm.u, qc.u, qp.u),
        v=slope(qm.v, qc.v, qp.v),
        p=slope(qm.p, qc.p, qp.p),
    )
    qL = Prim(
        rho=qc.rho - 0.5 * s.rho, u=qc.u - 0.5 * s.u, v=qc.v - 0.5 * s.v,
        p=qc.p - 0.5 * s.p,
    )
    qR = Prim(
        rho=qc.rho + 0.5 * s.rho, u=qc.u + 0.5 * s.u, v=qc.v + 0.5 * s.v,
        p=qc.p + 0.5 * s.p,
    )
    return enforce_positive_faces(qL, qc, qR)


def half_step_predict(q: Prim, dF: Cons, half_dt_dn, gamma: float) -> Prim:
    """MUSCL-Hancock half-step predictor (tau_hypersonic_cuda.cu:443-455):
    advance a face state by half a step of the cell's flux difference."""
    c = prim_to_cons(q, gamma)
    c = Cons(
        rho=c.rho - half_dt_dn * dF.rho,
        mx=c.mx - half_dt_dn * dF.mx,
        my=c.my - half_dt_dn * dF.my,
        E=c.E - half_dt_dn * dF.E,
    )
    return clamp_prim(cons_to_prim(c, gamma))
