"""MHD, Stam-3D, and CPU Stam reference tests."""

import jax
import jax.numpy as jnp
import numpy as np

from fluidsims_tpu.solvers import mhd, stam2d_cpu, stam3d


# -------------------------------- MHD --------------------------------------


def test_mhd_glm_flux_consistency():
    cfg = mhd.MHDConfig(nx=8, ny=8, dtype="float64")
    q = mhd.PrimM(*(jnp.asarray(x, jnp.float64) for x in
                    (1.0, 0.3, -0.2, 0.8, 0.4, -0.1, 0.0)))
    U = mhd.prim_to_cons(q, cfg.gamma)
    ch = jnp.asarray(0.0, jnp.float64)
    for xdir in (True, False):
        F = mhd.hlld_glm_flux(U, U, cfg.gamma, ch, xdir)
        Fref = mhd.glm_flux(U, cfg.gamma, ch, xdir)
        # With ch=0 and symmetric states the HLL flux averages to the
        # physical flux
        for a, b in zip(F, Fref):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-10,
                                       atol=1e-12)


def test_mhd_briowu_runs_and_shocks_form():
    cfg = mhd.MHDConfig(nx=128, ny=16, problem="briowu")
    s = mhd.init(cfg)
    out = jax.jit(lambda st: mhd.run(cfg, st, 100))(s)
    q = mhd.cons_to_prim(out.U, cfg.gamma)
    rho = np.asarray(q.rho)
    assert np.isfinite(rho).all()
    assert rho.min() > 0
    # Brio-Wu: intermediate states develop between 0.125 and 1.0
    mid = rho[8, cfg.nx // 2 - 10: cfg.nx // 2 + 10]
    assert ((mid > 0.14) & (mid < 0.99)).any()
    assert float(out.t) > 0


def test_mhd_orszag_tang_reference_mode_stays_finite():
    # The reference's anti-diffusive HLL sign (tau_mhd.c:123) lets OT grow
    # large values; the invalid-cell revert keeps everything finite. We only
    # assert finiteness in behavioral-parity mode.
    cfg = mhd.MHDConfig(nx=64, ny=64, problem="orszag-tang")
    s = mhd.init(cfg)
    out = jax.jit(lambda st: mhd.run(cfg, st, 80))(s)
    for f in out.U:
        assert np.isfinite(np.asarray(f)).all()
    divb = np.asarray(mhd.view_field(cfg, out, 3))
    assert np.isfinite(divb).all()


def test_mhd_orszag_tang_stable_hll_bounded():
    cfg = mhd.MHDConfig(nx=64, ny=64, problem="orszag-tang", stable_hll=True)
    s = mhd.init(cfg)
    out = jax.jit(lambda st: mhd.run(cfg, st, 80))(s)
    q = mhd.cons_to_prim(out.U, cfg.gamma)
    rho = np.asarray(q.rho)
    assert np.isfinite(rho).all()
    # with the dissipative sign, density stays near the OT regime
    assert rho.max() < 10.0 * cfg.gamma**2
    assert np.abs(np.asarray(out.U.psi)).max() < 100.0


def test_mhd_mass_nearly_conserved_stable_mode():
    # The pair update is flux-form conservative, but the invalid-cell revert
    # (tau_mhd.c:173) breaks exact conservation when it fires. In stable-HLL
    # mode reverts are rare, so mass drift stays small.
    cfg = mhd.MHDConfig(nx=48, ny=32, dtype="float64", stable_hll=True)
    s = mhd.init(cfg)
    m0 = float(jnp.sum(s.U.rho))
    out = jax.jit(lambda st: mhd.run(cfg, st, 20))(s)
    m1 = float(jnp.sum(out.U.rho))
    assert abs(m1 - m0) / m0 < 1e-3


# ------------------------------ Stam 3D ------------------------------------


def test_stam3d_runs_and_bounded():
    cfg = stam3d.Stam3DConfig(n=24)
    s = stam3d.init(cfg)
    out = jax.jit(lambda st: stam3d.run(cfg, st, 6))(s)
    for name in ("u", "v", "w", "d"):
        f = np.asarray(getattr(out, name))
        assert np.isfinite(f).all(), name
    assert np.asarray(out.d).max() > 0


def test_stam3d_set_bnd_reflects():
    cfg = stam3d.Stam3DConfig(n=8)
    s = stam3d.init(cfg)
    u, v, w, d = stam3d.set_bnd(s.u, s.v, s.w, s.d)
    u_np = np.asarray(u)
    np.testing.assert_allclose(u_np[1:-1, 1:-1, 0], -u_np[1:-1, 1:-1, 1])
    v_np = np.asarray(v)
    np.testing.assert_allclose(v_np[1:-1, 0, 1:-1], -v_np[1:-1, 1, 1:-1])
    d_np = np.asarray(d)
    np.testing.assert_allclose(d_np[0, 1:-1, 1:-1], d_np[1, 1:-1, 1:-1])


def test_stam3d_iso_render():
    cfg = stam3d.Stam3DConfig(n=16)
    s = stam3d.init(cfg)
    img = np.asarray(stam3d.iso_render(cfg, s, W=60, H=30))
    assert img.shape == (30, 60)
    assert img.max() > 0
    assert img.min() >= 0 and img.max() <= 256


# --------------------------- CPU Stam (sim.c) ------------------------------


def test_stam2d_cpu_reference_runs():
    cfg = stam2d_cpu.Stam2DCPUConfig(n=24)
    sim = stam2d_cpu.Stam2DCPU(cfg)
    d0 = sim.d.copy()
    for _ in range(3):
        sim.step()
    assert np.isfinite(sim.d).all()
    assert np.isfinite(sim.u).all()
    assert not np.allclose(sim.d, d0)


def test_stam3d_dense_advection_matches_gather_within_cap():
    """_advect_dense reproduces the gather path exactly (to f32
    reassociation) whenever backtrace displacements stay within K cells."""
    from dataclasses import replace

    from fluidsims_tpu.solvers import stam3d as s3

    cfg_g = s3.Stam3DConfig(n=20, advect_k=0)
    cfg_d = replace(cfg_g, advect_k=2)
    rng = np.random.default_rng(0)
    q0 = jnp.asarray(rng.normal(size=(22, 22, 22)), jnp.float32)
    u = jnp.clip(jnp.asarray(rng.normal(size=(22, 22, 22)), jnp.float32)
                 * 1.5, -1.9, 1.9)
    v = jnp.roll(u, 3, 0)
    w = jnp.roll(u, 5, 1)
    a_g = np.asarray(s3._advect(cfg_g, q0, u, v, w))
    a_d = np.asarray(s3._advect(cfg_d, q0, u, v, w))
    np.testing.assert_allclose(a_d, a_g, atol=2e-6)

    # capped case stays finite and within the data range (convex weights)
    u2, v2, w2 = u * 5, v * 5, w * 5
    a_c = np.asarray(s3._advect(cfg_d, q0, u2, v2, w2))
    assert np.isfinite(a_c).all()
    assert a_c.max() <= float(q0.max()) + 1e-5
    assert a_c.min() >= float(q0.min()) - 1e-5


def test_stam3d_dense_advection_full_step():
    from fluidsims_tpu.solvers import stam3d as s3

    cfg = s3.Stam3DConfig(n=16, advect_k=2)
    s = s3.init(cfg)
    out = jax.jit(lambda st: s3.run(cfg, st, 5))(s)
    assert np.isfinite(np.asarray(out.d)).all()
    assert np.isfinite(np.asarray(out.u)).all()


def test_stam3d_resolve_engine_and_capped_count():
    import pytest

    # the fused-kernel engine option is gone: naming it fails loudly
    with pytest.raises(TypeError):
        stam3d.Stam3DConfig(n=16, engine="pallas")

    # capped count: zero for a calm field, nonzero for a violent one
    cfg = stam3d.Stam3DConfig(n=16, advect_k=2)
    s = stam3d.init(cfg)
    calm = s._replace(u=s.u * 0, v=s.v * 0, w=s.w * 0)
    assert int(stam3d.advect_capped_count(cfg, calm)) == 0
    wild = s._replace(u=jnp.ones_like(s.u) * 50.0)
    assert int(stam3d.advect_capped_count(cfg, wild)) > 0


def test_mhd_matches_loop_oracle_f64():
    """Full-pipeline cross-check vs the independent per-cell float64 oracle
    (tests/oracles/mhd_oracle.py), Brio-Wu in the parity flux mode."""
    from tests.oracles.mhd_oracle import MHDOracle

    cfg = mhd.MHDConfig(nx=32, ny=24, problem="briowu", dtype="float64")
    s = mhd.init(cfg)
    orc = MHDOracle(cfg, tuple(s.U), float(s.t))
    step = jax.jit(lambda st: mhd.step(cfg, st))
    for _ in range(4):
        s = step(s)
        orc.step()
    got = np.stack([np.asarray(f) for f in s.U], -1)
    assert np.abs(got - orc.U).max() < 1e-12
    np.testing.assert_allclose(float(s.t), orc.t, rtol=1e-12)


def test_stam3d_matches_loop_oracle_f64():
    """Full-frame cross-check vs the independent float64 oracle
    (tests/oracles/stam3d_oracle.py): decay, orbiting source with the
    crossed u<-dz assignment, warm-started ping-pong Jacobi with the
    alternating ghost ring, set_bnd placement, trilinear advection."""
    from tests.oracles.stam3d_oracle import Stam3DOracle

    # advect_k=0 pins the exact-gather advection the oracle transcribes
    cfg = stam3d.Stam3DConfig(n=12, dtype="float64", advect_k=0)
    s = stam3d.init(cfg)
    orc = Stam3DOracle(cfg, *[np.asarray(getattr(s, f)) for f in
                              ("u", "v", "w", "u0", "v0", "w0", "d", "d0")],
                       int(s.step_idx))
    step = jax.jit(lambda st: stam3d.step(cfg, st))
    for _ in range(2):
        s = step(s)
        orc.step()
    for name in ("u", "v", "w", "d", "u0", "d0"):
        got = np.asarray(getattr(s, name))
        ref = getattr(orc, name)
        assert np.abs(got - ref).max() < 1e-12, name


def test_mhd_resolve_engine_gates():
    import pytest as _pytest

    with _pytest.raises(TypeError):
        mhd.MHDConfig(engine="pallas")
    with _pytest.raises(TypeError):
        mhd.MHDConfig(block_k=8)
