"""Step drivers: compiled multi-step scan + host frame loop.

The reference batches `steps_per_frame` physics steps between host
interactions (tau_hypersonic_cuda.cu:1833, tau_lbm.cu:267-288).  Here the
whole batch compiles into one `lax.scan`, so the only host↔device boundary
is one `device_get` per frame for render/export — mirroring the reference's
one-readback-per-frame discipline but without its per-step dt sync.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import jax
from jax import lax

__all__ = ["scan_steps", "frame_loop", "benchmark"]


def scan_steps(step_fn: Callable[[Any], Any], state: Any, n_steps: int):
    """Run `n_steps` applications of `step_fn` inside one lax.scan.

    `step_fn(state) -> state`; replaces the reference's per-step kernel-launch
    loop with a single compiled region.
    """

    def body(carry, _):
        return step_fn(carry), None

    out, _ = lax.scan(body, state, None, length=n_steps)
    return out


def frame_loop(
    step_fn: Callable[[Any], Any],
    state: Any,
    n_frames: int,
    steps_per_frame: int,
    on_frame: Callable[[int, Any], None] | None = None,
):
    """Host-side frame loop: scan a batch of steps, then call `on_frame`.

    This is the analog of the reference's render loop — each frame is one
    jitted multi-step scan followed by at most one device→host readback
    (inside `on_frame`, via jax.device_get).
    """
    batched = jax.jit(functools.partial(scan_steps, step_fn, n_steps=steps_per_frame))

    for f in range(n_frames):
        state = batched(state)
        if on_frame is not None:
            on_frame(f, state)
    return state


def benchmark(
    step_fn: Callable[[Any], Any],
    state: Any,
    steps: int,
    warmup_steps: int = 10,
    cells: int | None = None,
) -> dict:
    """Headless benchmark: jit-scan `steps` steps, report wall-clock rates.

    Mirrors the reference's --headless benches (js_cuda.cu:401-441,
    tau_burgers.cu:790-820): warmup (compile) excluded, steps/sec and
    cells/sec (MLUPS analog, tau_lbm.cu:291-294) reported.
    """
    # n_steps feeds lax.scan(length=...) and must be compile-time static.
    scan = jax.jit(functools.partial(scan_steps, step_fn), static_argnames=("n_steps",))

    warm = scan(state, n_steps=max(1, warmup_steps))
    jax.block_until_ready(warm)

    t0 = time.perf_counter()
    out = scan(state, n_steps=steps)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    result = {
        "steps": steps,
        "wall_s": dt,
        "steps_per_sec": steps / dt,
    }
    if cells is not None:
        result["cells"] = cells
        result["mcells_per_sec"] = cells * steps / dt / 1e6
    return result
