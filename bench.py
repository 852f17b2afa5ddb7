#!/usr/bin/env python
"""Per-solver timing on the accelerator.

Prints one JSON line per cell: the flagship 2-D hypersonic step (2048^2
f32 unless overridden) first, then one line per solver at the size
`cells()` gives it (the reference program's default where it has one).
Each line names the device (`platform`, `device_kind`, `device_count`),
the engine that ran, the compile seconds, every timing window's rate and
their median as `value`.  A window runs `chunk`-step scans for about
`total` steps and ends in a host sync; compilation is excluded.

Env overrides: FST_BENCH_NX / FST_BENCH_NY / FST_BENCH_STEPS for the
flagship; FST_BENCH_SWEEP=0 skips the per-solver sweep.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Any, Callable, NamedTuple

WINDOWS = 5


class Cell(NamedTuple):
    solver: str         # module name under fluidsims_tpu.solvers
    metric: str
    unit: str
    scale: float        # steps/s -> unit (e.g. cells/1e6 for MLUPS)
    cfg: Any
    init: Callable      # init(cfg) -> state
    step: Callable      # step(cfg, state) -> state
    total: int          # steps per timing window
    chunk: int          # steps per compiled scan

    @property
    def engine(self) -> str:
        if hasattr(self.cfg, "advect_k"):
            return f"advect_k={self.cfg.advect_k}"
        return getattr(self.cfg, "engine", "xla")


def flagship_cell(nx: int = 2048, ny: int = 2048, steps: int = 100) -> Cell:
    from fluidsims_tpu.solvers import hypersonic2d as h2

    chunk = max(1, min(50, steps))
    return Cell("hypersonic2d", f"hypersonic2d_{nx}x{ny}_steps_per_sec",
                "steps/sec", 1.0,
                h2.default_config(nx=nx, ny=ny), h2.init, h2.step,
                max(steps, chunk), chunk)


def sweep_cells() -> list[Cell]:
    """Every other solver at its timing size, on its default engine.
    Fast solvers run enough steps per window that a window lasts well
    over the host's dispatch and sync latency."""
    import fluidsims_tpu.solvers.burgers as bg
    import fluidsims_tpu.solvers.flip_apic as fa
    import fluidsims_tpu.solvers.gray_scott as gs
    import fluidsims_tpu.solvers.hypersonic3d as h3
    import fluidsims_tpu.solvers.lbm as lbm
    import fluidsims_tpu.solvers.mhd as mhd
    import fluidsims_tpu.solvers.mpm as mpm
    import fluidsims_tpu.solvers.nbody_graph as nb
    import fluidsims_tpu.solvers.shallow_water as sw
    import fluidsims_tpu.solvers.sph as sph
    import fluidsims_tpu.solvers.stam2d as s2
    import fluidsims_tpu.solvers.stam3d as s3

    lbm_cfg = lbm.LBMConfig(nx=2048, ny=1024)
    sph_cfg = sph.SPHConfig(n=1 << 16, rain=False)
    flip_cfg = fa.FlipApicConfig()
    mpm_cfg = mpm.MPMConfig()
    return [
        Cell("gray_scott", "gray_scott_2048x2048_steps_per_sec",
             "steps/sec", 1.0, gs.GrayScottConfig(nx=2048, ny=2048),
             gs.init, gs.step, 2000, 500),
        Cell("burgers", "burgers_512x512_steps_per_sec", "steps/sec", 1.0,
             bg.BurgersConfig(nx=512, ny=512), bg.init, bg.step, 4000, 1000),
        Cell("shallow_water", "shallow_water_512x512_steps_per_sec",
             "steps/sec", 1.0, sw.ShallowWaterConfig(nx=512, ny=512),
             sw.init, sw.step, 4000, 1000),
        Cell("mhd", "mhd_320x220_steps_per_sec", "steps/sec", 1.0,
             mhd.MHDConfig(), mhd.init, mhd.step, 4000, 1000),
        Cell("lbm", "lbm_2048x1024_mlups", "MLUPS",
             lbm_cfg.nx * lbm_cfg.ny / 1e6, lbm_cfg, lbm.init, lbm.step,
             1000, 250),
        Cell("sph", "sph_65536_mpsps", "M particle-steps/sec",
             sph_cfg.n / 1e6, sph_cfg, sph.init, sph.step, 100, 10),
        Cell("flip_apic", "flip_65536_mpsps", "M particle-steps/sec",
             flip_cfg.particles / 1e6, flip_cfg, fa.init, fa.step, 100, 10),
        Cell("mpm", "mpm_32768_mpsps", "M particle-steps/sec",
             mpm_cfg.n / 1e6, mpm_cfg, mpm.init, mpm.step, 100, 10),
        Cell("hypersonic3d", "hypersonic3d_64_steps_per_sec", "steps/sec",
             1.0, h3.Hypersonic3DConfig(), h3.init, h3.step, 400, 100),
        Cell("stam2d", "stam2d_512x512_steps_per_sec", "steps/sec", 1.0,
             s2.Stam2DConfig(), s2.init, s2.step, 400, 100),
        Cell("stam3d", "stam3d_192_steps_per_sec", "steps/sec", 1.0,
             s3.Stam3DConfig(), s3.init, s3.step, 20, 5),
        Cell("nbody_graph", "nbody_131072_exact_steps_per_sec", "steps/sec",
             1.0, nb.GraphLayoutConfig(max_number=1 << 17), nb.init,
             nb.step, 20, 5),
    ]


def measure(cell: Cell, windows: int = WINDOWS, total: int | None = None):
    """Compile the cell's `chunk`-step scan, then time `windows` windows of
    about `total` steps.  Returns (window rates in steps/s, compile
    seconds, final state)."""
    import jax

    from fluidsims_tpu.core.stepper import scan_steps

    state = cell.init(cell.cfg)
    run = jax.jit(lambda s: scan_steps(lambda st: cell.step(cell.cfg, st),
                                       s, cell.chunk))
    t0 = time.perf_counter()
    compiled = run.lower(state).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(state))
    reps = max(1, (cell.total if total is None else total) // cell.chunk)
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = compiled(out)
        jax.block_until_ready(out)
        rates.append(reps * cell.chunk / (time.perf_counter() - t0))
    return rates, compile_s, out


def device_fields() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def record(cell: Cell, rates, compile_s: float) -> dict:
    return {
        "metric": cell.metric,
        "value": statistics.median(rates) * cell.scale,
        "unit": cell.unit,
        "windows": [r * cell.scale for r in rates],
        "compile_s": compile_s,
        "engine": cell.engine,
        "dtype": getattr(cell.cfg, "dtype", "float32"),
        **device_fields(),
    }


def main():
    import jax

    from fluidsims_tpu.core.platform import enable_compile_cache

    enable_compile_cache(jax)
    cells = [flagship_cell(int(os.environ.get("FST_BENCH_NX", "2048")),
                           int(os.environ.get("FST_BENCH_NY", "2048")),
                           int(os.environ.get("FST_BENCH_STEPS", "100")))]
    if os.environ.get("FST_BENCH_SWEEP", "1") != "0":
        cells += sweep_cells()
    for cell in cells:
        rates, compile_s, _ = measure(cell)
        print(json.dumps(record(cell, rates, compile_s)), flush=True)


if __name__ == "__main__":
    main()
