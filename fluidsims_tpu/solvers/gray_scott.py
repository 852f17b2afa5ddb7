"""Gray–Scott two-species reaction–diffusion.

Behavioral spec: tau_gray_scott.cu — 5-point periodic Laplacian + reaction
(step_kernel, tau_gray_scott.cu:141-171), seeded center square + 64
xorshift32 random speckles (init_pattern, :173-204), defaults Du=0.2 Dv=0.1
F=0.03 k=0.06 dt=1 dx=1 seed=1337 (:43-61).

Design: the entire update is one fused elementwise+shift dataflow; XLA
fuses the rolls and arithmetic into a single memory-bound pass over (u, v).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core.config import BaseConfig
from ..ops.shift import shift_wrapped

__all__ = ["GrayScottConfig", "GrayScottState", "init", "step", "run"]


@dataclass(frozen=True)
class GrayScottConfig(BaseConfig):
    nx: int = 128
    ny: int = 128
    dx: float = 1.0
    dt: float = 1.0
    Du: float = 0.2
    Dv: float = 0.1
    feed: float = 0.03
    kill: float = 0.06
    seed: int = 1337
    dtype: str = "float32"

    def validate(self):
        self._require(self.nx > 0 and self.ny > 0, "grid dims must be positive")
        self._require(self.dx > 0 and self.dt > 0, "dx, dt must be positive")
        self._require(self.Du >= 0 and self.Dv >= 0, "diffusivities must be >= 0")


class GrayScottState(NamedTuple):
    u: jnp.ndarray  # (ny, nx)
    v: jnp.ndarray


def init(cfg: GrayScottConfig) -> GrayScottState:
    """Uniform u=1, v=0 with a perturbed center square and 64 speckles."""
    nx, ny = cfg.nx, cfg.ny
    u = np.ones((ny, nx), dtype=np.float32)
    v = np.zeros((ny, nx), dtype=np.float32)

    cx, cy = nx // 2, ny // 2
    r = min(nx, ny) // 12
    for j in range(-r, r + 1):
        for i in range(-r, r + 1):
            x = (cx + i + nx) % nx
            y = (cy + j + ny) % ny
            u[y, x] = 0.50
            v[y, x] = 0.25

    # The reference draws x then y from one xorshift32 stream per speckle.
    state = np.uint32(cfg.seed if cfg.seed else 1)

    def rng():
        nonlocal state
        s = int(state)
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        state = np.uint32(s)
        return s

    for _ in range(64):
        x = rng() % nx
        y = rng() % ny
        u[y, x] = 0.35
        v[y, x] = 0.65

    dt = cfg.jax_dtype
    return GrayScottState(u=jnp.asarray(u, dt), v=jnp.asarray(v, dt))


def _laplacian_periodic(f, inv_dx2):
    return (
        shift_wrapped(f, 0, 1)
        + shift_wrapped(f, 0, -1)
        + shift_wrapped(f, 1, 0)
        + shift_wrapped(f, -1, 0)
        - 4.0 * f
    ) * inv_dx2


def step(cfg: GrayScottConfig, s: GrayScottState,
         feed=None, kill=None) -> GrayScottState:
    """One forward-Euler reaction-diffusion update (tau_gray_scott.cu:141-171).
    `feed`/`kill` override cfg and may be traced scalars, so interactive
    F/k nudges re-run the compiled step instead of recompiling."""
    feed = cfg.feed if feed is None else feed
    kill = cfg.kill if kill is None else kill
    inv_dx2 = 1.0 / (cfg.dx * cfg.dx)
    lap_u = _laplacian_periodic(s.u, inv_dx2)
    lap_v = _laplacian_periodic(s.v, inv_dx2)
    uvv = s.u * s.v * s.v
    du = cfg.Du * lap_u - uvv + feed * (1.0 - s.u)
    dv = cfg.Dv * lap_v + uvv - (feed + kill) * s.v
    return GrayScottState(u=s.u + cfg.dt * du, v=s.v + cfg.dt * dv)


def run(cfg: GrayScottConfig, s: GrayScottState, n_steps: int,
        feed=None, kill=None) -> GrayScottState:
    from ..core.stepper import scan_steps

    return scan_steps(lambda st: step(cfg, st, feed=feed, kill=kill), s,
                      n_steps)
