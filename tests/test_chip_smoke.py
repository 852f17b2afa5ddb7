"""chip_smoke.py on the CPU: its per-solver phase functions at a tiny size
with the device check left out, and its refusal to report anything when
JAX finds no GPU or the rest of the repository is missing."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import bench
import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = {c.solver: c for c in [bench.flagship_cell()] + bench.sweep_cells()}


def test_every_bench_solver_has_a_small_size():
    assert set(CELLS) == set(cs.SMALL)


@pytest.mark.parametrize("solver", sorted(cs.SMALL))
def test_solver_phases_at_tiny_size(solver):
    """Phase 3 (two backends agree) with CPU on both sides, and phase 4
    (compile, time, finite) on the small configuration."""
    cpu = jax.devices("cpu")[0]
    cell = CELLS[solver]
    assert cs.compare_backends(cell, cpu, cpu) == 0.0
    rate, compile_s = cs.time_cell(cs.small_cell(cell))
    assert rate > 0.0 and compile_s >= 0.0


def test_max_rel_diff_flags_float_and_mask_changes():
    import numpy as np

    a = {"x": np.ones(4, np.float32), "m": np.zeros(4, bool)}
    b = {"x": np.ones(4, np.float32) * (1 + 1e-3), "m": np.zeros(4, bool)}
    assert 9e-4 < cs.max_rel_diff(a, b) < 1.1e-3
    c = dict(b, m=np.ones(4, bool))
    assert cs.max_rel_diff(a, c) == float("inf")


def test_flagship_step_report_fields():
    line = cs.flagship_step_report(jax, 64, 32)
    for key in ("compile_s=", "temp_bytes=", "entry_fusions=",
                "bytes_accessed="):
        assert key in line


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_gpu():
    p = _run(ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
