"""LBM tests: pull-formulation step must equal the reference's push scheme
(per-cell NumPy oracle), plus conservation and flow development checks."""

import jax
import numpy as np

from fluidsims_tpu.solvers import lbm


def push_oracle_step(f, solid, cfg):
    """Direct NumPy transcription of collide_stream_kernel
    (tau_lbm.cu:94-132): push scheme with on-link bounce-back."""
    ny, nx = solid.shape
    fout = np.zeros_like(f)
    EX, EY, OPP, W = lbm.EX, lbm.EY, lbm.OPP, lbm.W

    def feq(q, rho, ux, uy):
        cu = 3.0 * (EX[q] * ux + EY[q] * uy)
        u2 = ux * ux + uy * uy
        return W[q] * rho * (1.0 + cu + 0.5 * cu * cu - 1.5 * u2)

    for j in range(ny):
        for i in range(nx):
            local = f[:, j, i]
            if solid[j, i]:
                for q in range(9):
                    fout[OPP[q], j, i] = local[q]
                continue
            rho = max(local.sum(), 1e-6)
            ux = (local * EX).sum() / rho + cfg.drive
            uy = (local * EY).sum() / rho
            omega = 1.0 / cfg.tau
            for q in range(9):
                post = local[q] - omega * (local[q] - feq(q, rho, ux, uy))
                ni = (i + EX[q] + nx) % nx
                nj = j + EY[q]
                if nj < 0 or nj >= ny or solid[nj, ni]:
                    fout[OPP[q], j, i] = post
                else:
                    fout[q, nj, ni] = post
    return fout


def test_pull_matches_push_oracle():
    cfg = lbm.LBMConfig(nx=32, ny=16, obstacle=True, obstacle_radius=4.0)
    s = lbm.init(cfg)
    f = np.asarray(s.f, np.float64)
    solid = np.asarray(s.solid)

    step = jax.jit(lambda st: lbm.step(cfg, st))
    for _ in range(3):
        s = step(s)
        f = push_oracle_step(f, solid, cfg)

    np.testing.assert_allclose(np.asarray(s.f, np.float64), f, rtol=2e-5,
                               atol=1e-7)


def test_mass_conserved_without_drive():
    # With drive=0 the BGK collide+bounce-back conserves total mass exactly.
    cfg = lbm.LBMConfig(nx=64, ny=32, drive=0.0)
    s = lbm.init(cfg)
    m0 = float(np.asarray(s.f, np.float64).sum())
    out = jax.jit(lambda st: lbm.run(cfg, st, 50))(s)
    m1 = float(np.asarray(out.f, np.float64).sum())
    np.testing.assert_allclose(m1, m0, rtol=1e-5)


def test_channel_flow_develops():
    cfg = lbm.LBMConfig(nx=64, ny=32, drive=1e-4, obstacle=False)
    s = lbm.init(cfg)
    out = jax.jit(lambda st: lbm.run(cfg, st, 400))(s)
    sp = np.asarray(lbm.speed_field(cfg, out))
    fluid = sp >= 0
    assert np.isfinite(sp[fluid]).all()
    # body-forced channel flow: interior faster than near-wall rows
    mid = sp[cfg.ny // 2, :].mean()
    near_wall = sp[1, :].mean()
    assert mid > near_wall


def test_pull_matches_push_oracle_f64():
    """The pull-streaming solver reproduces the reference's PUSH
    collide+stream (tau_lbm.cu:94-132) exactly — cross-checked against an
    independent per-cell float64 push oracle (tests/oracles/lbm_oracle.py);
    differences are summation-order ulps only."""
    from tests.oracles.lbm_oracle import LBMOracle

    cfg = lbm.LBMConfig(nx=48, ny=32, dtype="float64")
    s = lbm.init(cfg)
    orc = LBMOracle(cfg, np.asarray(s.f), np.asarray(s.solid))
    step = jax.jit(lambda st: lbm.step(cfg, st))
    for _ in range(5):
        s = step(s)
        orc.step()
    assert np.abs(np.asarray(s.f) - orc.f).max() < 1e-13


def test_run_with_traced_drive_matches_stepping():
    """`run(..., drive=d)` (the interactive drive nudge, a traced scalar so
    it never recompiles) equals stepping with the same override, walls and
    obstacle included."""
    cfg = lbm.LBMConfig(nx=100, ny=48, drive=1e-4, obstacle_radius=8.0)
    s = lbm.init(cfg)
    ref = s
    for _ in range(7):
        ref = lbm.step(cfg, ref, drive=3e-4)
    out = jax.jit(lambda st, d: lbm.run(cfg, st, 7, drive=d))(s, 3e-4)
    np.testing.assert_allclose(np.asarray(out.f), np.asarray(ref.f),
                               atol=1e-6)


def test_lbm_engine_validation():
    import pytest

    with pytest.raises(TypeError):
        lbm.LBMConfig(engine="pallas")
    with pytest.raises(TypeError):
        lbm.LBMConfig(block_k=8)


def test_poiseuille_matches_analytic():
    """Analytic validation the reference lacks: body-forced channel flow
    relaxes to the exact Poiseuille parabola u(y) = a/(2 nu) * y (H - y)
    with nu = cs^2 (tau - 1/2) and the on-link bounce-back wall plane
    sitting half a cell inside the solid rows.  The velocity-shift
    forcing (u_eq = u + drive) injects omega*rho*drive of momentum per
    step, so the effective acceleration is a = drive/tau.  Validates
    the viscosity relation, the forcing normalization, and the wall
    placement in one measurement."""
    tau, drive = 0.8, 1e-6
    cfg = lbm.LBMConfig(nx=32, ny=34, tau=tau, drive=drive, obstacle=False)
    s0 = lbm.init(cfg)
    # start from rest (init seeds a sinusoidal shear)
    f0 = np.stack([
        lbm.feq(q, cfg.rho0, np.zeros((34, 32)), np.zeros((34, 32)))
        for q in range(9)
    ])
    import jax.numpy as jnp

    s = lbm.LBMState(f=jnp.asarray(f0, jnp.float32), solid=s0.solid)
    s = jax.jit(lambda st: lbm.run(cfg, st, 20000))(s)

    _, ux, _ = lbm.macroscopic(s.f)
    prof = np.asarray(ux)[:, 16]
    nu = (tau - 0.5) / 3.0          # cs^2 (tau - 1/2), cs^2 = 1/3
    a = drive / tau                  # velocity-shift forcing
    y = np.arange(34) - 0.5          # wall planes at y=0 and y=H
    H = 32.0
    exact = a / (2 * nu) * y * (H - y)
    fl = slice(1, 33)
    rel = np.abs(prof[fl] - exact[fl]) / exact[fl].max()
    assert rel.max() < 0.02, rel.max()
