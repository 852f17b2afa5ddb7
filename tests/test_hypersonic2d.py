"""Flagship 2-D hypersonic solver: oracle cross-check + snapshot regression.

The reference's physics-correctness gate is the baseline snapshot regression
(tau_hypersonic_cuda_tests.cu:143-176,494-559).  Here the oracle is an
independent loop-structured float64 NumPy transcription of the same
algorithm (tests/oracles/hypersonic2d_oracle.py); the JAX solver must match
it to round-off at float64 and to float32 tolerance at f32.
"""


import jax
import numpy as np

from fluidsims_tpu.solvers import hypersonic2d as h2
from tests.oracles import hypersonic2d_oracle as oracle


def small_cfg(dtype="float64", nx=40, ny=20):
    return h2.Hypersonic2DConfig(
        nx=nx,
        ny=ny,
        geom_x0=nx / 8.0,
        geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0,
        geom_Rn=ny / 24.0,
        dtype=dtype,
    )


def oracle_cfg(nx=40, ny=20):
    return oracle.Cfg(nx=nx, ny=ny)


def as_np(U):
    return np.stack([np.asarray(f, np.float64) for f in U], axis=-1)


def test_mask_matches_oracle():
    cfg = small_cfg()
    mask = np.asarray(h2.build_mask(cfg))
    omask = oracle.build_mask(oracle_cfg())
    np.testing.assert_array_equal(mask, omask)
    assert mask.any() and not mask.all()


def test_init_matches_oracle():
    cfg = small_cfg()
    s = h2.init(cfg)
    oU, omask = oracle.init(oracle_cfg())
    np.testing.assert_allclose(as_np(s.U), oU, rtol=1e-12, atol=1e-12)


def test_steps_match_oracle_float64():
    cfg = small_cfg("float64")
    s = h2.init(cfg)
    oU, omask = oracle.init(oracle_cfg())

    step = jax.jit(lambda st: h2.step(cfg, st))
    for i in range(6):
        s = step(s)
        oU, odt = oracle.step(oracle_cfg(), oU, omask)

    got = as_np(s.U)
    fl = ~omask
    np.testing.assert_allclose(got[fl], oU[fl], rtol=1e-10, atol=1e-10)
    # simulated time advanced identically
    assert float(s.t) > 0.0


def test_steps_match_oracle_float32_tolerance():
    cfg = small_cfg("float32")
    s = h2.init(cfg)
    oU, omask = oracle.init(oracle_cfg())

    step = jax.jit(lambda st: h2.step(cfg, st))
    for _ in range(6):
        s = step(s)
        oU, _ = oracle.step(oracle_cfg(), oU, omask)

    got = as_np(s.U)
    fl = ~omask
    # float32 relative tolerance vs the f64 oracle; fields are O(1..1e3)
    scale = np.maximum(np.abs(oU[fl]), 1.0)
    err = np.abs(got[fl] - oU[fl]) / scale
    assert float(err.max()) < 5e-4, f"max rel err {err.max()}"


def compute_snapshot(cfg, U, mask):
    """RegressionSnapshot reduction (tau_hypersonic_cuda_tests.cu:143-176):
    conserved sums, min rho/p, max Mach, position-weighted checksums, all
    accumulated on the host in float64."""
    rho, mx, my, E = [np.asarray(f, np.float64) for f in U]
    fl = ~np.asarray(mask)
    g = cfg.gamma
    r = np.maximum(rho[fl], 1e-25)
    u = mx[fl] / r
    v = my[fl] / r
    eint = E[fl] - 0.5 * r * (u * u + v * v)
    p = (g - 1.0) * np.maximum(eint, 1e-25)
    a = np.sqrt(g * p / r)
    machs = np.sqrt(u * u + v * v) / np.maximum(a, 1e-30)
    idx = np.arange(rho.size).reshape(rho.shape)[fl]
    w = (idx % 8191 + 1).astype(np.float64)
    return {
        "fluid_cells": int(fl.sum()),
        "sum_rho": float(r.sum()),
        "sum_mx": float(mx[fl].sum()),
        "sum_my": float(my[fl].sum()),
        "sum_E": float(E[fl].sum()),
        "min_rho": float(r.min()),
        "min_p": float(p.min()),
        "max_mach": float(machs.max()),
        "checksum_rho": float((w * r).sum()),
        "checksum_mx": float((w * mx[fl]).sum()),
        "checksum_E": float((w * E[fl]).sum()),
    }


def test_snapshot_regression_roundtrip(tmp_path):
    """Write-then-verify snapshot gate on the same machine
    (Makefile:39-43 semantics) with the reference tolerances."""
    import json

    cfg = small_cfg("float32", nx=64, ny=32)
    s = h2.init(cfg)
    s = jax.jit(lambda st: h2.run(cfg, st, 12))(s)
    snap = compute_snapshot(cfg, s.U, s.mask)

    assert snap["fluid_cells"] > 0
    assert snap["min_rho"] >= 1e-25
    assert snap["min_p"] > 0

    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(snap))

    s2 = h2.init(cfg)
    s2 = jax.jit(lambda st: h2.run(cfg, st, 12))(s2)
    snap2 = compute_snapshot(cfg, s2.U, s2.mask)
    expected = json.loads(path.read_text())
    assert snap2["fluid_cells"] == expected["fluid_cells"]
    for k, v in expected.items():
        if k == "fluid_cells":
            continue
        assert abs(snap2[k] - v) <= 5e-8 * abs(v) + 1e-8, k


def test_physics_bow_shock_forms():
    """After enough steps a bow shock forms: density well above inflow
    upstream of the body, and max Mach stays near the inflow Mach."""
    cfg = small_cfg("float32", nx=96, ny=48)
    s = h2.init(cfg)
    s = jax.jit(lambda st: h2.run(cfg, st, 60))(s)
    rho = np.asarray(s.U.rho)
    mask = np.asarray(s.mask)
    assert np.isfinite(rho[~mask]).all()
    # compression ahead of the body
    assert rho[~mask].max() > 1.5
    # inflow region untouched
    np.testing.assert_allclose(rho[:, 0][~mask[:, 0]], 1.0, rtol=1e-6)
