"""Tracing / profiling / observability utilities.

Mirrors the reference's measurement machinery (SURVEY.md §5): wall + device
timing brackets (cudaEvent analog -> block_until_ready brackets), domain
throughput metrics (steps/sec, MLUPS = cells*steps/1e6/s,
particle-steps/sec), EMA-smoothed FPS counters (0.95/0.05,
tau_shallow_water.cu:729-731), and jax.profiler trace capture for the
Nsight `-lineinfo` role.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax

__all__ = ["EMA", "Throughput", "device_timer", "trace"]


@dataclass
class EMA:
    """Exponential moving average, reference smoothing 0.95/0.05."""

    alpha: float = 0.05
    value: float = 0.0
    initialized: bool = False

    def update(self, x: float) -> float:
        if not self.initialized:
            self.value = x
            self.initialized = True
        else:
            self.value = (1.0 - self.alpha) * self.value + self.alpha * x
        return self.value


@dataclass
class Throughput:
    """steps/sec + cells/sec (MLUPS) + particle-steps/sec reporter."""

    cells: int | None = None
    particles: int | None = None
    _t0: float = field(default_factory=time.perf_counter)
    _steps: int = 0

    def tick(self, n_steps: int = 1):
        self._steps += n_steps

    def report(self) -> dict:
        wall = time.perf_counter() - self._t0
        out = {"steps": self._steps, "wall_s": wall,
               "steps_per_sec": self._steps / wall if wall > 0 else 0.0}
        if self.cells:
            out["mlups"] = self.cells * self._steps / wall / 1e6
        if self.particles:
            out["particle_steps_per_sec"] = (
                self.particles * self._steps / wall
            )
        return out


@contextlib.contextmanager
def device_timer(result_holder: dict, key: str = "wall_s"):
    """Bracket a region with full device sync on both sides — the analog
    of the reference's cudaEvent pairs (js_cuda.cu:404-437)."""
    (jax.device_put(0.0) + 0).block_until_ready()
    t0 = time.perf_counter()
    yield
    jax.effects_barrier()
    result_holder[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/fst_trace"):
    """jax.profiler trace capture (open with TensorBoard / Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
