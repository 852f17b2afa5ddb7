#!/usr/bin/env python
"""Quickest proof that the system runs on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: phase 6 only

Everything runs in this one JAX process (a second JAX process on the
card would fail for want of memory).  Phases:

  1. device: JAX's first device must be a GPU (no CPU fallback); the
     card's name and power limit come from nvidia-smi;
  2. flagship through the user's entry point, `cli.main`, at 2048^2 and
     at the reference's 8192x1024, with the step's compile time, memory
     plan, fusion count and bytes per step;
  3. correctness on the card: every solver runs a few steps at a small
     size on the GPU and on the CPU backend of this process, and the
     flagship runs against its float64 loop oracle;
  4. every solver bench.py times, at its bench size, on its default
     engine: a few steps, finite output, steps/s and compile seconds;
  5. A/B of existing engines: FLIP and MPM dense vs scatter, Stam 3-D
     advect_k=2 vs the exact gather advect_k=0;
  6. (--four-cards) the flagship x-slab runner and the 2x2 device grid at
     8192x1024 over four cards, each against the one-card run.

The phases run in the order 1, 2, 4, 5, 3, so that a tolerance miss in
phase 3 still leaves the rates on record.  Any failure raises, so the
script exits non-zero and never prints the last line, one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

# GPU-vs-CPU tolerances: the max abs difference of each float field after
# `steps` steps, over that field's max magnitude.  XLA's GPU fusions sum
# in another order than the CPU's and may contract a*b+c into one FMA, so
# each step can differ by a few f32 ulps (~1e-7) per operation chain.
# Smooth updates (reaction-diffusion, lattice Boltzmann, Jacobi-based
# projection, particle transfers) keep that at ~1e-6 over a few steps;
# limiter- and Riemann-solver-based steps can flip a min/max or upwind
# select on a 1-ulp tie, which moves that cell by a limiter increment
# once, so they get 1e-3.
SMOOTH, LIMITED = 1e-4, 1e-3


def _resize(**kw):
    return lambda cfg: cfg.replace(**kw)


def _hypersonic2d_small(cfg):
    from fluidsims_tpu.solvers import hypersonic2d as h2

    return h2.default_config(nx=128, ny=64)


def _hypersonic3d_small(cfg):
    from fluidsims_tpu.solvers import hypersonic3d as h3

    return h3.default_config(16)


SMALL = {
    # solver: (bench config -> small config, steps, tolerance)
    "hypersonic2d": (_hypersonic2d_small, 3, LIMITED),
    "gray_scott": (_resize(nx=96, ny=64), 5, SMOOTH),
    "burgers": (_resize(nx=64, ny=48, dtau=1e-2), 3, LIMITED),
    "shallow_water": (_resize(nx=64, ny=48, dtau=1e-3), 3, LIMITED),
    "mhd": (_resize(nx=64, ny=44), 3, LIMITED),
    "lbm": (_resize(nx=128, ny=64, obstacle_radius=8.0), 5, SMOOTH),
    "sph": (_resize(n=4096), 3, SMOOTH),
    "flip_apic": (_resize(particles=4096, grid=32, jacobi=8), 3, SMOOTH),
    "mpm": (_resize(n=4096, gx=48, gy=48), 3, SMOOTH),
    "hypersonic3d": (_hypersonic3d_small, 3, LIMITED),
    "stam2d": (_resize(n=64), 3, SMOOTH),
    "stam3d": (_resize(n=24), 2, SMOOTH),
    "nbody_graph": (_resize(max_number=2048), 3, SMOOTH),
}
# flagship vs the float64 loop oracle: the size, step count and relative
# tolerance of tests/test_hypersonic2d.py's float32 check
ORACLE_NX, ORACLE_NY, ORACLE_STEPS, ORACLE_TOL = 40, 20, 6, 5e-4
# sharded vs one-card flagship: the halo-extend+crop construction is
# exact; the per-slab programs fuse differently, so fields agree to f32
# rounding (tests/test_sharded.py's bound) grown over the steps run
SHARDED_STEPS, SHARDED_TOL = 20, 1e-4


def card() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def require_gpu(jax) -> None:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (first device is "
                         f"{dev.platform}); nothing to prove here")


def small_cell(cell):
    """The bench cell at its phase-3 size."""
    shrink, steps, _ = SMALL[cell.solver]
    return cell._replace(cfg=shrink(cell.cfg), chunk=steps)


def max_rel_diff(a, b) -> float:
    """Largest per-field max|a-b| / max|b| over the float leaves of two
    states; non-float leaves (masks, counters) must match exactly.  A
    field below a millionth of the state's largest field is the float32
    roundoff of a quantity that is exactly zero (e.g. the transverse
    velocities of the symmetric 3-D flow, ~1e-15), so it is measured on
    that millionth instead of on its own noise."""
    import jax
    import numpy as np

    pairs = [(np.asarray(x), np.asarray(y))
             for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))]
    floats = [(x, y) for x, y in pairs
              if np.issubdtype(y.dtype, np.floating)]
    if any(not np.array_equal(x, y) for x, y in pairs
           if not np.issubdtype(y.dtype, np.floating)):
        return float("inf")
    floor = 1e-6 * max([float(np.abs(y).max()) for _, y in floats] + [0.0])
    worst = 0.0
    for x, y in floats:
        scale = max(float(np.abs(y).max()), floor, 1e-30)
        worst = max(worst, float(np.abs(x - y).max()) / scale)
    return worst


def run_steps(cell, device):
    """cell.chunk steps of the cell's step from its init state, placed on
    `device`; returns the state on the host."""
    import jax

    from fluidsims_tpu.core.stepper import scan_steps

    s0 = jax.device_put(cell.init(cell.cfg), device)
    run = jax.jit(lambda s: scan_steps(lambda st: cell.step(cell.cfg, st),
                                       s, cell.chunk))
    with jax.default_matmul_precision("highest"):
        return jax.device_get(run(s0))


def compare_backends(cell, ref_device, test_device) -> float:
    """Phase 3 for one solver: the same steps on two devices."""
    small = small_cell(cell)
    return max_rel_diff(run_steps(small, test_device),
                        run_steps(small, ref_device))


def check_finite(state) -> None:
    """Every float field of the state is finite.  Scalar clocks are left
    out: the tau-clock solvers grow t by e^dtau per step exactly as the
    reference does (tau_burgers.cu:756-757), so t overflows to inf after
    ~88 float32 steps at dtau=1 while the fields stay bounded (dt is then
    the CFL limit alone)."""
    import jax
    import numpy as np

    for leaf in jax.tree.leaves(state):
        a = np.asarray(leaf)
        if (a.ndim and np.issubdtype(a.dtype, np.floating)
                and not np.isfinite(a).all()):
            raise AssertionError("non-finite values in the state")


def time_cell(cell, windows: int = 1, steps: int | None = None):
    """Phase 4/5 for one cell: compile, run, check finite.  Returns
    (median steps/s, compile seconds)."""
    import statistics

    import bench

    rates, compile_s, out = bench.measure(
        cell, windows=windows, total=cell.chunk if steps is None else steps)
    check_finite(out)
    return statistics.median(rates), compile_s


def flagship_step_report(jax, nx: int, ny: int) -> str:
    """Compile one flagship step alone: compile seconds, memory plan,
    fusions in the optimized HLO and the bytes XLA's cost model says the
    step moves."""
    from fluidsims_tpu.solvers import hypersonic2d as h2

    cfg = h2.default_config(nx=nx, ny=ny)
    state = h2.init(cfg)
    t0 = time.perf_counter()
    compiled = jax.jit(lambda s: h2.step(cfg, s)).lower(state).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    hlo = compiled.as_text()
    entry = hlo[hlo.index("ENTRY"):]
    fusions = len(re.findall(r"= [^=]*? fusion\(", entry))
    kernels = len(re.findall(r"= [^=]*? (?:fusion|custom-call|copy|"
                             r"reduce|scatter|gather|sort)\(", entry))
    return (f"step compile_s={compile_s:.3f} "
            f"args_bytes={mem.argument_size_in_bytes} "
            f"out_bytes={mem.output_size_in_bytes} "
            f"temp_bytes={mem.temp_size_in_bytes} "
            f"entry_fusions={fusions} entry_kernels={kernels} "
            f"bytes_accessed={cost.get('bytes accessed', float('nan')):.0f}")


def phase_flagship(jax, where: str) -> None:
    from fluidsims_tpu import cli

    for nx, ny in ((2048, 2048), (8192, 1024)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["hypersonic2d", "--nx", str(nx), "--ny", str(ny),
                           "--steps", "50", "--headless"])
        text = buf.getvalue()
        m = re.search(r"-> ([0-9.]+) steps/s", text)
        if rc != 0 or m is None:
            raise AssertionError(f"cli.main failed at {nx}x{ny}: {text!r}")
        print(f"flagship {nx}x{ny} cli steps/s={m.group(1)} "
              f"{flagship_step_report(jax, nx, ny)} [{where}]", flush=True)


def phase_correctness(jax, cells, where: str) -> None:
    import importlib.util
    import os

    import numpy as np

    from fluidsims_tpu.solvers import hypersonic2d as h2

    # loaded by path: an installed package may own the name `tests`
    spec = importlib.util.spec_from_file_location(
        "hypersonic2d_oracle", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "oracles",
            "hypersonic2d_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    failed = []
    for cell in cells:
        _, steps, tol = SMALL[cell.solver]
        err = compare_backends(cell, cpu, gpu)
        print(f"gpu-vs-cpu {cell.solver} steps={steps} "
              f"max_rel_diff={err:.3e} tol={tol:.0e} [{where}]", flush=True)
        if not err <= tol:
            failed.append(cell.solver)

    cfg = h2.Hypersonic2DConfig(
        nx=ORACLE_NX, ny=ORACLE_NY, geom_x0=ORACLE_NX / 8.0,
        geom_cy=ORACLE_NY / 2.0, geom_Rb=ORACLE_NY / 12.0,
        geom_Rn=ORACLE_NY / 24.0)
    ocfg = oracle.Cfg(nx=ORACLE_NX, ny=ORACLE_NY)
    step = jax.jit(lambda s: h2.step(cfg, s))
    s = jax.device_put(h2.init(cfg), gpu)
    oU, omask = oracle.init(ocfg)
    for _ in range(ORACLE_STEPS):
        s = step(s)
        oU, _ = oracle.step(ocfg, oU, omask)
    got = np.stack([np.asarray(f, np.float64) for f in s.U], -1)
    fl = ~omask
    err = float((np.abs(got[fl] - oU[fl])
                 / np.maximum(np.abs(oU[fl]), 1.0)).max())
    print(f"flagship-vs-f64-oracle {ORACLE_NX}x{ORACLE_NY} "
          f"steps={ORACLE_STEPS} max_rel_err={err:.3e} tol={ORACLE_TOL:.0e} "
          f"[{where}]", flush=True)
    if not err < ORACLE_TOL:
        failed.append("flagship-vs-oracle")
    if failed:
        raise AssertionError(f"outside tolerance: {failed}")


def phase_bench(cells, where: str) -> None:
    for cell in cells:
        rate, compile_s = time_cell(cell)
        print(f"bench {cell.metric} engine={cell.engine} "
              f"steps/s={rate:.2f} compile_s={compile_s:.3f} finite=yes "
              f"[{where}]", flush=True)


def phase_ab(cells, where: str) -> None:
    by_solver = {c.solver: c for c in cells}
    pairs = [("flip_apic", "engine", "dense", "scatter"),
             ("mpm", "engine", "dense", "scatter"),
             ("stam3d", "advect_k", 2, 0)]
    for solver, field, a, b in pairs:
        base = by_solver[solver]
        line = []
        for value in (a, b):
            cell = base._replace(cfg=base.cfg.replace(**{field: value}))
            rate, _ = time_cell(cell, windows=5, steps=base.total)
            line.append(f"{field}={value}:{rate:.3f}")
        print(f"ab {solver} median steps/s " + " ".join(line)
              + f" [{where}]", flush=True)


def phase_four_cards(jax, where: str, nx: int = 8192,
                     ny: int = 1024) -> None:
    import numpy as np

    from fluidsims_tpu.parallel import hypersonic2d_sharded as sh
    from fluidsims_tpu.parallel import hypersonic2d_sharded2d as sh2
    from fluidsims_tpu.parallel.mesh import make_mesh_1d
    from fluidsims_tpu.solvers import hypersonic2d as h2

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                         f"{len(jax.devices())}")
    cfg = h2.default_config(nx=nx, ny=ny)
    s0 = h2.init(cfg)
    one = jax.jit(lambda s: h2.run(cfg, s, SHARDED_STEPS))
    ref = jax.device_get(one(jax.device_put(s0, jax.devices()[0])))

    def timed(run, state):
        out = jax.block_until_ready(run(state))       # compile + warm
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(out))
        return out, SHARDED_STEPS / (time.perf_counter() - t0)

    _, one_rate = timed(one, jax.device_put(s0, jax.devices()[0]))
    print(f"four-cards one-card {nx}x{ny} steps/s={one_rate:.2f} [{where}]",
          flush=True)
    mesh = make_mesh_1d(4)
    mesh2 = sh2.make_mesh_2d(2, 2)
    runs = {
        "x-slab 1x4": (sh.make_sharded_run(cfg, mesh, SHARDED_STEPS),
                       sh.shard_state(s0, mesh)),
        "grid 2x2": (sh2.make_sharded_run(cfg, mesh2, SHARDED_STEPS),
                     sh2.shard_state(s0, mesh2)),
    }
    for name, (run, state) in runs.items():
        got = jax.device_get(run(state))
        err = max(
            float((np.abs(np.asarray(a) - np.asarray(b))
                   / np.maximum(np.abs(np.asarray(b)), 1.0)).max())
            for a, b in zip(got.U, ref.U))
        _, rate = timed(run, state)
        print(f"four-cards {name} {nx}x{ny} steps={SHARDED_STEPS} "
              f"max_rel_diff_vs_one_card={err:.3e} tol={SHARDED_TOL:.0e} "
              f"steps/s={rate:.2f} [{where}]", flush=True)
        if not err <= SHARDED_TOL:
            raise AssertionError(f"{name}: differs from one card by {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded flagship phase")
    args = ap.parse_args(argv)

    import jax

    import bench
    from fluidsims_tpu.core.platform import enable_compile_cache

    enable_compile_cache(jax)
    require_gpu(jax)
    where = card()
    print(f"card: {where}", flush=True)
    print(f"jax {jax.__version__} devices: {jax.devices()}", flush=True)

    if args.four_cards:
        phase_four_cards(jax, where)
    else:
        cells = [bench.flagship_cell()] + bench.sweep_cells()
        phase_flagship(jax, where)
        phase_bench(cells, where)
        phase_ab(cells, where)
        phase_correctness(jax, cells, where)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
