"""Gray–Scott solver tests: exact match vs a direct NumPy transcription of
the reference kernel, init-pattern parity, determinism, and invariants."""

import jax
import jax.numpy as jnp
import numpy as np

from fluidsims_tpu.solvers import gray_scott as gs


def numpy_reference_step(u, v, cfg):
    """Direct float32 NumPy transcription of step_kernel
    (tau_gray_scott.cu:141-171) as the oracle."""
    u = u.astype(np.float32)
    v = v.astype(np.float32)
    inv_dx2 = np.float32(1.0 / (cfg.dx * cfg.dx))

    def lap(f):
        return (
            np.roll(f, -1, axis=1)
            + np.roll(f, 1, axis=1)
            + np.roll(f, -1, axis=0)
            + np.roll(f, 1, axis=0)
            - np.float32(4.0) * f
        ) * inv_dx2

    uvv = u * v * v
    du = np.float32(cfg.Du) * lap(u) - uvv + np.float32(cfg.feed) * (np.float32(1.0) - u)
    dv = np.float32(cfg.Dv) * lap(v) + uvv - np.float32(cfg.feed + cfg.kill) * v
    return u + np.float32(cfg.dt) * du, v + np.float32(cfg.dt) * dv


def test_init_pattern_structure():
    cfg = gs.GrayScottConfig(nx=64, ny=48)
    s = gs.init(cfg)
    u = np.asarray(s.u)
    v = np.asarray(s.v)
    assert u.shape == (48, 64)
    # center square perturbed
    assert u[24, 32] == np.float32(0.5)
    assert v[24, 32] == np.float32(0.25)
    # far corner is background unless a speckle landed there
    assert set(np.unique(v)) <= {np.float32(0.0), np.float32(0.25), np.float32(0.65)}
    # 64 speckles drawn (some may overlap square/others)
    assert np.count_nonzero(v == np.float32(0.65)) > 0


def test_step_matches_numpy_reference():
    cfg = gs.GrayScottConfig(nx=40, ny=24)
    s = gs.init(cfg)
    u, v = np.asarray(s.u), np.asarray(s.v)
    for _ in range(5):
        u, v = numpy_reference_step(u, v, cfg)
    out = gs.run(cfg, s, 5)
    np.testing.assert_allclose(np.asarray(out.u), u, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.v), v, rtol=1e-6, atol=1e-6)


def test_run_deterministic_and_finite():
    cfg = gs.GrayScottConfig(nx=64, ny=64)
    s = gs.init(cfg)
    a = gs.run(cfg, s, 50)
    b = gs.run(cfg, s, 50)
    assert jnp.array_equal(a.u, b.u) and jnp.array_equal(a.v, b.v)
    assert bool(jnp.all(jnp.isfinite(a.u)))
    assert bool(jnp.all(jnp.isfinite(a.v)))
    # pattern should have evolved away from init
    assert not jnp.array_equal(a.v, s.v)


def test_jit_compatible():
    cfg = gs.GrayScottConfig(nx=32, ny=32)
    s = gs.init(cfg)
    stepped = jax.jit(lambda st: gs.step(cfg, st))(s)
    ref = gs.step(cfg, s)
    np.testing.assert_allclose(np.asarray(stepped.u), np.asarray(ref.u), rtol=1e-6)


def test_matches_loop_oracle_f64():
    from tests.oracles.gray_scott_oracle import GrayScottOracle

    cfg = gs.GrayScottConfig(nx=32, ny=24, dtype="float64")
    s = gs.init(cfg)
    orc = GrayScottOracle(cfg, np.asarray(s.u), np.asarray(s.v))
    step = jax.jit(lambda st: gs.step(cfg, st))
    for _ in range(5):
        s = step(s)
        orc.step()
    np.testing.assert_allclose(np.asarray(s.u), orc.u, atol=1e-13)
    np.testing.assert_allclose(np.asarray(s.v), orc.v, atol=1e-13)


def test_run_with_traced_feed_kill_matches_stepping():
    """`run(..., feed=F, kill=k)` with traced overrides (the interactive
    F/k nudges) equals stepping with the same parameters."""
    cfg = gs.GrayScottConfig(nx=100, ny=64, feed=0.0367, kill=0.0649)
    s = gs.init(cfg)
    ref = s
    for _ in range(9):
        ref = gs.step(cfg, ref, feed=0.04, kill=0.058)
    out = jax.jit(lambda st, F, k: gs.run(cfg, st, 9, feed=F, kill=k))(
        s, 0.04, 0.058)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.v), np.asarray(ref.v),
                               atol=1e-6)


def test_gray_scott_engine_validation():
    """The step is plain XLA on every platform: the K-step kernel's
    `engine`/`block_k` options no longer exist, and passing one fails
    loudly instead of being ignored."""
    import pytest

    with pytest.raises(TypeError):
        gs.GrayScottConfig(engine="pallas")
    with pytest.raises(TypeError):
        gs.GrayScottConfig(block_k=16)
