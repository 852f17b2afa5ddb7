"""D2Q9 BGK lattice Boltzmann with fused collide+stream and on-link
bounce-back.

Behavioral spec: tau_lbm.cu — lattice tables (:56-61), BGK equilibrium
(feq :68-72), channel walls + optional cylinder obstacle (init_kernel
:74-92), fused collide+stream with on-link bounce-back and a body-force-like
x drive (collide_stream_kernel :94-132), speed render (:134-155), MLUPS
metric (:291-294).

Design: the reference PUSHES post-collision packets to neighbors
(scattered writes).  This is the PULL formulation of the identical update,
which needs no scatter: each fluid cell's slot q receives the
post-collision q-packet of the upstream cell (i - e_q), or its own opp(q)
packet when the upstream link is a wall (on-link bounce-back), and solid
cells reflect all packets in place.  Slot-for-slot equal to the reference's
push (verified against a NumPy push oracle in tests/test_lbm.py).
f is one (9, ny, nx) array so XLA fuses the whole update into a single
memory-bound pass, the shape of the reference's one fused
collide_stream_kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.config import BaseConfig
from ..ops.shift import shift_axis_wrapped

__all__ = ["LBMConfig", "LBMState", "EX", "EY", "OPP", "W", "feq",
           "init", "step", "run", "macroscopic", "speed_field"]

# D2Q9 lattice: rest, +x, +y, -x, -y, then diagonals (tau_lbm.cu:56-61).
EX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1])
EY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1])
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])
W = np.array(
    [4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36],
    dtype=np.float64,
)


@dataclass(frozen=True)
class LBMConfig(BaseConfig):
    nx: int = 512
    ny: int = 256
    tau: float = 0.56         # viscosity = cs^2 (tau - 1/2)
    drive: float = 1.0e-6
    rho0: float = 1.0
    obstacle: bool = True
    obstacle_radius: float = 32.0
    dtype: str = "float32"

    def validate(self):
        self._require(self.nx >= 16 and self.ny >= 16, "grid must be >= 16^2")
        self._require(self.tau >= 0.501, "tau must be > 0.5 for stability")


class LBMState(NamedTuple):
    f: jnp.ndarray       # (9, ny, nx)
    solid: jnp.ndarray   # bool (ny, nx)


def feq(q: int, rho, ux, uy, dtype=None):
    """BGK second-order equilibrium (tau_lbm.cu:68-72)."""
    cu = 3.0 * (float(EX[q]) * ux + float(EY[q]) * uy)
    u2 = ux * ux + uy * uy
    return float(W[q]) * rho * (1.0 + cu + 0.5 * cu * cu - 1.5 * u2)


def build_solid(cfg: LBMConfig) -> np.ndarray:
    """Channel walls at j=0, ny-1 plus optional cylinder at (0.28 nx, ny/2)."""
    j = np.arange(cfg.ny)[:, None]
    i = np.arange(cfg.nx)[None, :]
    wall = (j == 0) | (j == cfg.ny - 1)
    cx, cy = 0.28 * cfg.nx, 0.5 * cfg.ny
    cyl = cfg.obstacle & (
        (i - cx) ** 2 + (j - cy) ** 2 < cfg.obstacle_radius**2
    )
    return np.broadcast_to(wall | cyl, (cfg.ny, cfg.nx)).copy()


def init(cfg: LBMConfig) -> LBMState:
    """Equilibrium init with a sinusoidal shear profile (tau_lbm.cu:88-92)."""
    solid = build_solid(cfg)
    j = np.arange(cfg.ny)[:, None]
    shear = 0.015 * np.sin(
        2.0 * np.pi * j / (cfg.ny - 1 if cfg.ny > 1 else 1)
    )
    ux = np.broadcast_to(shear, (cfg.ny, cfg.nx))
    uy = np.zeros((cfg.ny, cfg.nx))
    f = np.stack([feq(q, cfg.rho0, ux, uy) for q in range(9)])
    dt = cfg.jax_dtype
    return LBMState(f=jnp.asarray(f, dt), solid=jnp.asarray(solid))


def macroscopic(f):
    """(rho, ux, uy) moments; rho floored at 1e-6 (tau_lbm.cu:113-119)."""
    rho = jnp.sum(f, axis=0)
    ex = jnp.asarray(EX, f.dtype).reshape(9, 1, 1)
    ey = jnp.asarray(EY, f.dtype).reshape(9, 1, 1)
    ux = jnp.sum(f * ex, axis=0)
    uy = jnp.sum(f * ey, axis=0)
    rho = jnp.maximum(rho, 1e-6)
    return rho, ux / rho, uy / rho


def step(cfg: LBMConfig, s: LBMState, drive=None) -> LBMState:
    """Fused collide + stream, pull formulation (see module docstring).

    `drive` optionally overrides cfg.drive as a traced scalar so the
    interactive +/- nudges (tau_lbm.cu:281-286) do not recompile."""
    f, solid = s.f, s.solid
    ny = cfg.ny

    rho, ux, uy = macroscopic(f)
    ux = ux + (cfg.drive if drive is None else drive)
    omega = 1.0 / cfg.tau

    post = [f[q] - omega * (f[q] - feq(q, rho, ux, uy)) for q in range(9)]

    out = []
    for q in range(9):
        exq, eyq = int(EX[q]), int(EY[q])
        # upstream source cell: (i - ex, j - ey), x periodic, y bounded
        src_post = shift_axis_wrapped(post[q], -exq, axis=1)
        src_post = shift_axis_wrapped(src_post, -eyq, axis=0)
        src_solid = shift_axis_wrapped(solid, -eyq, axis=0)
        src_solid = shift_axis_wrapped(src_solid, -exq, axis=1)

        if eyq > 0:
            oob = jnp.asarray(np.arange(ny) < eyq)[:, None]
        elif eyq < 0:
            oob = jnp.asarray(np.arange(ny) >= ny + eyq)[:, None]
        else:
            oob = jnp.zeros((ny, 1), bool)
        src_invalid = src_solid | oob

        streamed = jnp.where(src_invalid, post[int(OPP[q])], src_post)
        # solid cells reflect every packet in place (tau_lbm.cu:108-111)
        out.append(jnp.where(solid, f[int(OPP[q])], streamed))

    return LBMState(f=jnp.stack(out), solid=solid)


def speed_field(cfg: LBMConfig, s: LBMState):
    """|u| per cell, -1 on solids (render_kernel, tau_lbm.cu:134-155)."""
    rho, ux, uy = macroscopic(s.f)
    sp = jnp.sqrt(ux * ux + uy * uy)
    return jnp.where(s.solid, -1.0, sp)


def run(cfg: LBMConfig, s: LBMState, n_steps: int, drive=None) -> LBMState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st, drive=drive), s, n_steps)
