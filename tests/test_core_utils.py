"""Core utilities: checkpoint roundtrip, τ-clock semantics, metrics, CLI."""

import jax.numpy as jnp
import numpy as np

from fluidsims_tpu.core import checkpoint as ckpt
from fluidsims_tpu.core.clock import TauClock, cfl_dt, tau_tick, tau_tick_feedback
from fluidsims_tpu.core.metrics import EMA, Throughput


def test_checkpoint_roundtrip(tmp_path):
    from fluidsims_tpu.solvers import gray_scott as gs

    cfg = gs.GrayScottConfig(nx=32, ny=16)
    s = gs.init(cfg)
    s2 = gs.run(cfg, s, 5)
    p = tmp_path / "state.npz"
    ckpt.save_state(p, s2)
    restored = ckpt.load_state(p, s)
    np.testing.assert_array_equal(np.asarray(restored.u), np.asarray(s2.u))
    np.testing.assert_array_equal(np.asarray(restored.v), np.asarray(s2.v))
    # resuming from the checkpoint continues identically
    a = gs.run(cfg, restored, 3)
    b = gs.run(cfg, s2, 3)
    np.testing.assert_array_equal(np.asarray(a.v), np.asarray(b.v))


def test_checkpoint_rejects_mismatched_state(tmp_path):
    """A checkpoint restored into a template with a different tree structure
    or leaf shapes must fail loudly, not restore garbage."""
    import pytest

    from fluidsims_tpu.solvers import gray_scott as gs

    cfg = gs.GrayScottConfig(nx=32, ny=16)
    s = gs.init(cfg)
    p = tmp_path / "state.npz"
    ckpt.save_state(p, s)

    # different leaf shapes, same structure
    other = gs.init(gs.GrayScottConfig(nx=16, ny=16))
    with pytest.raises(ValueError):
        ckpt.load_state(p, other)

    # different tree structure entirely (same leaf count)
    from fluidsims_tpu.core.clock import TauClock as TC

    bogus = TC(t=jnp.zeros(()), tau=jnp.zeros(()), dtau=jnp.zeros(()))
    with pytest.raises(ValueError):
        ckpt.load_state(p, bogus)


def test_sharded_checkpoint_resume_bitwise():
    """Save a mesh-sharded flagship state mid-trajectory, restore it onto
    the mesh, continue — bitwise equal to the uninterrupted sharded run,
    and the restored leaves carry the mesh sharding."""
    import jax

    from fluidsims_tpu.parallel import hypersonic2d_sharded as sh
    from fluidsims_tpu.parallel.mesh import make_mesh_1d
    from fluidsims_tpu.solvers import hypersonic2d as h2

    n_dev = 8
    nx, ny = 16 * n_dev, 32
    cfg = h2.Hypersonic2DConfig(
        nx=nx, ny=ny, geom_x0=nx / 8.0, geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0, geom_Rn=ny / 24.0)
    mesh = make_mesh_1d(n_dev)
    s0 = sh.shard_state(h2.init(cfg), mesh)
    run4 = sh.make_sharded_run(cfg, mesh, n_steps=4)

    import tempfile
    from pathlib import Path

    mid = run4(s0)
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "mid.npz"
        ckpt.save_state(p, mid)
        template = sh.shard_state(h2.init(cfg), mesh)
        restored = ckpt.load_state(p, template)

    # restored leaves are placed back on the mesh
    assert restored.U.rho.sharding.mesh is not None
    assert restored.U.rho.sharding == mid.U.rho.sharding

    resumed = run4(restored)
    uninterrupted = run4(mid)
    for a, b in zip(jax.tree_util.tree_leaves(resumed),
                    jax.tree_util.tree_leaves(uninterrupted)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cli_checkpoint_resume_bitwise(tmp_path):
    """--save-state / --load-state round trip through the flagship CLI:
    8 steps straight == 4 steps, checkpoint, resume 4 steps."""
    from fluidsims_tpu.cli import main

    full = tmp_path / "full.npz"
    mid = tmp_path / "mid.npz"
    end = tmp_path / "end.npz"
    base = ["hypersonic2d", "--nx", "64", "--ny", "32", "--headless"]
    main(base + ["--steps", "8", "--save-state", str(full)])
    main(base + ["--steps", "4", "--save-state", str(mid)])
    main(base + ["--steps", "4", "--load-state", str(mid),
                 "--save-state", str(end)])

    a = np.load(full)
    b = np.load(end)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_benchmark_runs():
    """core.stepper.benchmark must work with a static n_steps (ADVICE r1:
    it previously traced n_steps into lax.scan and always raised)."""
    from fluidsims_tpu.core.stepper import benchmark

    rep = benchmark(lambda x: x + 1, jnp.zeros((8, 8)), steps=5,
                    warmup_steps=2, cells=64)
    assert rep["steps"] == 5 and rep["steps_per_sec"] > 0
    assert "mcells_per_sec" in rep


def test_dtau_feedback_deadband():
    """The reference controller holds dτ inside the 0.85–1.10 deadband
    (tau_hypersonic_3d_cuda.cu:1697-1704) and clamps to [1e-7, 5e-2]."""
    from fluidsims_tpu.core.clock import dtau_feedback

    dtau = jnp.asarray(1e-3)
    # inside deadband: dt within [0.85, 1.10]*dt_cfl -> hold
    assert float(dtau_feedback(dtau, 1.0, 1.0)) == float(dtau)
    assert float(dtau_feedback(dtau, 1.05, 1.0)) == float(dtau)
    assert float(dtau_feedback(dtau, 0.90, 1.0)) == float(dtau)
    # overshoot -> shrink 0.8x; undershoot -> grow 1.1x
    assert abs(float(dtau_feedback(dtau, 1.2, 1.0)) - 0.8e-3) < 1e-9
    assert abs(float(dtau_feedback(dtau, 0.5, 1.0)) - 1.1e-3) < 1e-9
    # clamps
    assert float(dtau_feedback(jnp.asarray(1e-7), 2.0, 1.0)) == 1e-7
    assert float(dtau_feedback(jnp.asarray(5e-2), 0.1, 1.0)) == 5e-2


def test_tau_clock_caps_at_cfl():
    c = TauClock(t=jnp.asarray(10.0), tau=jnp.asarray(0.0),
                 dtau=jnp.asarray(0.1))
    c2, dt = tau_tick(c, jnp.asarray(0.5))
    assert float(dt) == 0.5          # t*dtau = 1.0 capped by dt_cfl
    assert float(c2.tau) == 0.1


def test_tau_feedback_shrinks_and_grows():
    # dtau = 1e-2 (inside the reference's [1e-7, 5e-2] clamp); t*dtau = 0.1
    c = TauClock(t=jnp.asarray(10.0), tau=jnp.asarray(0.0),
                 dtau=jnp.asarray(1e-2))
    c2, _ = tau_tick_feedback(c, jnp.asarray(0.05))   # overshoot -> shrink
    assert float(c2.dtau) < 1e-2
    c3, _ = tau_tick_feedback(c, jnp.asarray(100.0))  # headroom -> grow
    assert float(c3.dtau) > 1e-2


def test_cfl_dt_diffusion_cap():
    dt = cfl_dt(jnp.asarray(1.0), cfl=0.5, nu_max=10.0)
    assert abs(float(dt) - 0.025) < 1e-7  # 0.25/nu wins
    dt = cfl_dt(jnp.asarray(jnp.inf), cfl=0.5)
    assert float(dt) > 0  # non-finite wavespeed floored


def test_metrics():
    e = EMA()
    e.update(10.0)
    v = e.update(20.0)
    assert 10.0 < v < 20.0
    t = Throughput(cells=1000)
    t.tick(10)
    rep = t.report()
    assert rep["steps"] == 10 and "mlups" in rep


def test_cli_parser_covers_all_solvers():
    from fluidsims_tpu.cli import build_parser

    ap = build_parser()
    subs = ap._subparsers._group_actions[0].choices
    for name in ("gray-scott", "burgers", "shallow-water", "lbm",
                 "hypersonic2d", "hypersonic3d", "th3cs", "mhd", "stam2d",
                 "stam3d", "sph", "flip", "mpm", "nbody"):
        assert name in subs, name


def test_regression_write_verify_roundtrip(tmp_path):
    """make-test semantics: write a baseline then verify it on the same
    machine (Makefile:39-43), plus tamper detection."""
    from fluidsims_tpu import regression as rg

    base = tmp_path / "base.txt"
    code = rg.run_regression(nx=64, ny=32, steps=6, baseline=str(base),
                             write=True)
    assert code == 0 and base.exists()
    code = rg.run_regression(nx=64, ny=32, steps=6, baseline=str(base),
                             write=False)
    assert code == 0

    snap = rg.read_snapshot(base)
    snap["sum_rho"] *= 1.001
    rg.write_snapshot(base, snap)
    code = rg.run_regression(nx=64, ny=32, steps=6, baseline=str(base),
                             write=False)
    assert code == 1


def test_cli_smoke(capsys):
    """End-to-end CLI runs for a few solvers at tiny sizes."""
    from fluidsims_tpu.cli import main

    main(["gray-scott", "--nx", "32", "--ny", "16", "--steps", "10",
          "--headless"])
    out = capsys.readouterr().out
    assert "gray-scott: 10 steps" in out

    main(["lbm", "--nx", "32", "--ny", "16", "--steps", "10", "--headless"])
    out = capsys.readouterr().out
    assert "MLUPS" in out

    main(["burgers", "--nx", "64", "--ny", "1", "--colehopf", "--dtau",
          "1e-3", "--steps", "20", "--headless"])
    out = capsys.readouterr().out
    assert "cole-hopf rel L2 error" in out


def test_compact_indices_matches_flatnonzero():
    """The sort-free compaction must agree with jnp.flatnonzero in every
    regime: empty mask, count < m, count == m, count > m (first-m kept)."""
    import jax

    from fluidsims_tpu.ops.compact import compact_indices

    rng = np.random.default_rng(3)
    f = jax.jit(compact_indices, static_argnums=(1, 2))
    for density, m in [(0.0, 16), (0.01, 64), (0.05, 64), (0.5, 128),
                       (1.0, 32)]:
        mask = jnp.asarray(rng.random((48, 96)) < density)
        want = jnp.flatnonzero(mask, size=m, fill_value=7)
        got = f(mask, m, 7)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"density={density} m={m}")
