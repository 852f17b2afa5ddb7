"""Tests for Burgers (incl. the Cole–Hopf analytic gate), shallow water, and
Stam stable fluids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidsims_tpu.solvers import burgers as bg
from fluidsims_tpu.solvers import shallow_water as sw
from fluidsims_tpu.solvers import stam2d


# ------------------------------ Burgers -----------------------------------


def test_colehopf_analytic_error_small():
    """The reference's only convergence-against-truth test
    (tau_burgers.cu:16-19,720-736): 1-D viscous Burgers vs the exact
    Cole–Hopf solution, relative L2 error stays small."""
    cfg = bg.BurgersConfig(
        nx=256, ny=1, colehopf=True, nu=0.1, ck=4, ca=0.5,
        dtau=1e-3, t0=1.0, cfl=0.45, dtype="float64",
    )
    s = bg.init(cfg)
    # init encodes the exact solution at t=0 (the clock starts at t0=1)
    u_init = np.asarray(bg.velocities(cfg, s)[0])[0]
    np.testing.assert_allclose(u_init, bg.cole_hopf_exact(cfg, 0.0), rtol=1e-10)

    out = jax.jit(lambda st: bg.run(cfg, st, 200))(s)
    err = bg.cole_hopf_rel_l2(cfg, out)
    assert err < 0.05, f"Cole-Hopf rel L2 error {err}"


def test_colehopf_init_time_consistency():
    # init evaluates the exact solution at t=0 but the clock starts at t0;
    # the reference does the same (initialize_host vs t=P.t0) — the error
    # metric is computed against t_now, so the first-report error reflects
    # the t0 offset. Just check the exact-solution helper itself.
    cfg = bg.BurgersConfig(nx=64, ny=1, colehopf=True, nu=0.1)
    u = bg.cole_hopf_exact(cfg, 0.0)
    assert np.isfinite(u).all() and np.abs(u).max() > 0


def test_burgers_2d_decays_and_finite():
    cfg = bg.BurgersConfig(nx=64, ny=64, nu=0.05, dtau=1e-3, swirl=5.0)
    s = bg.init(cfg)
    u0, v0 = bg.velocities(cfg, s)
    e0 = float(jnp.sum(u0**2 + v0**2))
    out = jax.jit(lambda st: bg.run(cfg, st, 100))(s)
    u1, v1 = bg.velocities(cfg, out)
    e1 = float(jnp.sum(u1**2 + v1**2))
    assert np.isfinite(e1)
    assert e1 < e0  # viscous decay, no forcing
    assert float(out.tau) > 0


def test_burgers_muscl_runs():
    cfg = bg.BurgersConfig(nx=32, ny=32, muscl=True, dtau=1e-3)
    out = jax.jit(lambda st: bg.run(cfg, st, 10))(bg.init(cfg))
    assert bool(jnp.isfinite(out.phi_u).all())


# --------------------------- Shallow water --------------------------------


def test_sw_mass_conserved():
    """Periodic HLL update conserves total depth to round-off (before the
    positivity floor engages)."""
    cfg = sw.ShallowWaterConfig(nx=64, ny=64, dtau=1e-4, nu=0.0,
                                dtype="float64")
    s = sw.init(cfg)
    m0 = float(jnp.sum(sw.depth(s)))
    out = jax.jit(lambda st: sw.run(cfg, st, 50))(s)
    m1 = float(jnp.sum(sw.depth(out)))
    np.testing.assert_allclose(m1, m0, rtol=1e-12)


def test_sw_positivity_and_wave_spread():
    cfg = sw.ShallowWaterConfig(nx=96, ny=96, bump_amp=50.0, offx=0.0,
                                offy=0.0, asym=0.0, swirl=0.0, dtau=1e-3)
    s = sw.init(cfg)
    out = jax.jit(lambda st: sw.run(cfg, st, 100))(s)
    h = np.asarray(sw.depth(out))
    assert (h > 0).all()
    # gravity wave spreads: center anomaly decreases
    h0 = np.asarray(sw.depth(s))
    c = (cfg.ny // 2, cfg.nx // 2)
    assert abs(h[c] - cfg.H0) < abs(h0[c] - cfg.H0)


# ------------------------------ Stam 2D -----------------------------------


def test_stam_projection_reduces_divergence():
    # Smooth divergent field (a Gaussian monopole). The reference's Poisson
    # stencil ignores the log-η metric (k_lin uses uniform a=1,c=4 while
    # k_div/k_proj scale by dx), so the projection is approximate — assert
    # reduction, not elimination.
    cfg = stam2d.Stam2DConfig(n=64, dtype="float64")
    i = np.arange(64)[None, :] - 32.0
    j = np.arange(64)[:, None] - 32.0
    g = np.exp(-(i**2 + j**2) / 100.0)
    u = jnp.asarray(g * i / 10.0)
    v = jnp.asarray(g * j / 10.0)
    dxw = jnp.asarray(stam2d._cell_widths(cfg))

    def div(u, v):
        pu = np.pad(np.asarray(u), 1)
        pv = np.pad(np.asarray(v), 1)
        w = np.asarray(dxw)
        return -0.5 * (
            (pu[1:-1, 2:] - pu[1:-1, :-2]) / w[None, :]
            + (pv[2:, 1:-1] - pv[:-2, 1:-1]) / w[:, None]
        )

    u2, v2 = jax.jit(lambda a, b: stam2d._project(cfg, a, b, dxw, dxw))(u, v)
    d_before = np.abs(div(u, v)).mean()
    d_after = np.abs(div(u2, v2)).mean()
    assert d_after < 0.75 * d_before


def test_stam_density_decays_without_negatives():
    cfg = stam2d.Stam2DConfig(n=48)
    s = stam2d.init(cfg)
    out = jax.jit(lambda st: stam2d.run(cfg, st, 20))(s)
    d = np.asarray(out.d)
    assert np.isfinite(d).all()
    assert d.min() >= -1e-5  # semi-Lagrangian + decay keep density ~nonneg
    assert d.max() > 0


def test_stam_deterministic():
    cfg = stam2d.Stam2DConfig(n=32)
    s = stam2d.init(cfg)
    a = jax.jit(lambda st: stam2d.run(cfg, st, 5))(s)
    b = jax.jit(lambda st: stam2d.run(cfg, st, 5))(s)
    assert jnp.array_equal(a.d, b.d)


def test_shallow_water_matches_loop_oracle_f64():
    """Full-pipeline cross-check vs the independent per-cell float64 oracle
    (tests/oracles/shallow_water_oracle.py)."""
    from tests.oracles.shallow_water_oracle import SWOracle

    cfg = sw.ShallowWaterConfig(nx=40, ny=28, dtype="float64")
    s = sw.init(cfg)
    orc = SWOracle(cfg, np.asarray(s.sigma), np.asarray(s.u),
                   np.asarray(s.v), float(s.t), float(s.tau))
    step = jax.jit(lambda st: sw.step(cfg, st))
    for _ in range(4):
        s = step(s)
        orc.step()
    assert np.abs(np.asarray(s.sigma) - orc.sigma).max() < 1e-12
    assert np.abs(np.asarray(s.u) - orc.u).max() < 1e-12
    assert np.abs(np.asarray(s.v) - orc.v).max() < 1e-12
    np.testing.assert_allclose(float(s.t), orc.t, rtol=1e-12)


def test_burgers_2d_matches_loop_oracle_f64():
    """Full-pipeline cross-check vs the independent per-cell float64 oracle
    (tests/oracles/burgers_oracle.py), first-order and MUSCL paths."""
    from tests.oracles.burgers_oracle import BurgersOracle

    for muscl in (False, True):
        cfg = bg.BurgersConfig(nx=32, ny=24, muscl=muscl, visc_substeps=2,
                               dtype="float64")
        s = bg.init(cfg)
        orc = BurgersOracle(cfg, np.asarray(s.phi_u), np.asarray(s.phi_v),
                            float(s.t), float(s.tau))
        step = jax.jit(lambda st, c=cfg: bg.step(c, st))
        for _ in range(4):
            s = step(s)
            orc.step()
        assert np.abs(np.asarray(s.phi_u) - orc.pu).max() < 1e-12, muscl
        assert np.abs(np.asarray(s.phi_v) - orc.pv).max() < 1e-12, muscl
        np.testing.assert_allclose(float(s.t), orc.t, rtol=1e-12)


def test_stam2d_matches_loop_oracle_f64():
    """Full-frame cross-check vs the independent per-cell float64 oracle
    (tests/oracles/stam2d_oracle.py): decay, truncated orbiting source,
    warm-started Jacobi diffusion, metric divergence/projection, eta-space
    advection with the C int-cast, density step."""
    from tests.oracles.stam2d_oracle import Stam2DOracle

    cfg = stam2d.Stam2DConfig(n=24, jacobi_iters=10, dtype="float64")
    s = stam2d.init(cfg)
    orc = Stam2DOracle(cfg, np.asarray(s.u), np.asarray(s.v),
                       np.asarray(s.u0), np.asarray(s.v0),
                       np.asarray(s.d), np.asarray(s.d0), int(s.step_idx))
    step = jax.jit(lambda st: stam2d.step(cfg, st))
    for _ in range(3):
        s = step(s)
        orc.step()
    for name, ref in (("u", orc.u), ("v", orc.v), ("d", orc.d)):
        got = np.asarray(getattr(s, name))
        assert np.abs(got - ref[1:-1, 1:-1]).max() < 1e-12, name


def test_sw_engine_validation():
    """One plain XLA step: the resident-kernel options are gone, and
    naming one fails loudly."""
    with pytest.raises(TypeError):
        sw.ShallowWaterConfig(engine="pallas")
    with pytest.raises(TypeError):
        sw.ShallowWaterConfig(block_k=8)


def test_burgers_engine_validation():
    with pytest.raises(TypeError):
        bg.BurgersConfig(engine="pallas")
    with pytest.raises(TypeError):
        bg.BurgersConfig(colehopf=True, block_k=8)


@pytest.mark.parametrize("engine", ["pallas", "hybrid", "xla"])
def test_stam2d_engine_option_is_gone(engine):
    """Stam 2-D keeps one engine, the exact gather; the banded and hybrid
    engine names are refused rather than mapped to it."""
    with pytest.raises(TypeError):
        stam2d.Stam2DConfig(engine=engine)


def test_sw_standing_wave_dispersion():
    """Analytic validation: a small-amplitude standing wave h = H0 +
    eps cos(kx) oscillates at omega = k sqrt(g H0).  With the CFL-locked
    dt = cfl dx / c this is an integer number of steps per period, so
    the mode amplitude's zero crossings pin the dispersion relation
    exactly (measured 128 steps/period vs 128.0 expected)."""
    import math

    cfg = sw.ShallowWaterConfig(nx=128, ny=8, H0=100.0, nu=0.0,
                                bump_amp=0.0, swirl=0.0, dtau=1e9)
    s0 = sw.init(cfg)
    eps, k = 0.01, 2 * math.pi * 2 / 128.0
    x = np.arange(128.0)
    h = 100.0 + eps * np.cos(k * x)[None, :] * np.ones((8, 1))
    s = sw.ShallowWaterState(
        sigma=jnp.asarray(np.log(h), jnp.float32),
        u=jnp.zeros((8, 128), jnp.float32),
        v=jnp.zeros((8, 128), jnp.float32),
        t=s0.t, tau=s0.tau)

    c = math.sqrt(9.81 * 100.0)
    dt = 0.5 * 1.0 / c                      # cfl*dx/(0 + c)
    expected = 2 * math.pi / (k * c) / dt   # steps per period
    run1 = jax.jit(lambda st: sw.run(cfg, st, 1))
    cosk = jnp.asarray(np.cos(k * x), jnp.float32)
    amps = []
    for _ in range(200):
        amps.append(float(jnp.mean(
            (jnp.exp(s.sigma)[0, :] - 100.0) * cosk)))
        s = run1(s)
    sign = np.sign(np.asarray(amps))
    zc = np.where(np.diff(sign) != 0)[0]
    assert len(zc) >= 2
    measured = 2 * (zc[1] - zc[0])
    assert abs(measured - expected) <= 3, (measured, expected)
