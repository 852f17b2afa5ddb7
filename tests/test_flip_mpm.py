"""FLIP/APIC and MPM tests: transfer-operator exactness (partition of unity,
momentum conservation), stability, and material behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidsims_tpu.solvers import flip_apic as fa
from fluidsims_tpu.solvers import mpm


# ----------------------------- FLIP/APIC -----------------------------------


def test_p2g_partition_of_unity_and_momentum():
    cfg = fa.FlipApicConfig(particles=2048, grid=64)
    s = fa.init(cfg)
    mass, u, v = fa._p2g(cfg, s.pos, s.vel, s.affine_x, s.affine_y)
    # hat weights sum to 1 per particle (interior particles; seed keeps all
    # well inside [0.02, 0.98])
    np.testing.assert_allclose(float(jnp.sum(mass)), cfg.particles, rtol=1e-4)
    # with zero affine matrices, grid momentum equals particle momentum
    np.testing.assert_allclose(
        float(jnp.sum(u)), float(jnp.sum(s.vel[:, 0])), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        float(jnp.sum(v)), float(jnp.sum(s.vel[:, 1])), rtol=1e-3, atol=1e-3
    )


def test_flip_runs_stable_and_counts_particles():
    cfg = fa.FlipApicConfig(particles=4096, grid=64)
    s = fa.init(cfg)
    out = jax.jit(lambda st: fa.run(cfg, st, 40))(s)
    pos = np.asarray(out.pos)
    assert np.isfinite(pos).all()
    assert (pos >= 0.01 - 1e-6).all() and (pos <= 0.99 + 1e-6).all()
    assert int(jnp.sum(out.density)) == cfg.particles
    # gravity pulls the blob down over time
    assert pos[:, 1].mean() < float(s.pos[:, 1].mean())


def test_flip_projection_reduces_divergence():
    cfg = fa.FlipApicConfig(particles=8192, grid=64, jacobi=80)
    s = fa.init(cfg)
    out1 = jax.jit(lambda st: fa.step(cfg, st))(s)
    # velocities after one step should carry much less divergence than the
    # raw swirl+gravity field; proxy: no blow-up over repeated projection
    out2 = jax.jit(lambda st: fa.run(cfg, st, 20))(out1)
    v = np.asarray(out2.vel)
    assert np.isfinite(v).all()
    assert np.abs(v).max() < 50.0


# -------------------------------- MPM --------------------------------------


def test_mpm_mass_conservation_in_p2g():
    cfg = mpm.MPMConfig(n=2048)
    s = mpm.init(cfg)
    out = jax.jit(lambda st: mpm.step(cfg, st))(s)
    assert bool(jnp.isfinite(out.pos).all())
    # particles stay inside the clamped box
    pos = np.asarray(out.pos)
    dx = cfg.dx
    assert (pos[:, 0] >= 2 * dx - 1e-6).all()
    assert (pos[:, 0] <= (cfg.gx - 3) * dx + 1e-6).all()


def test_mpm_materials_diverge():
    """Different plasticity models must produce different dynamics."""
    outs = {}
    for m in ("mud", "snow", "sand"):
        cfg = mpm.MPMConfig(n=1024, material=m, seed=5)
        s = mpm.init(cfg)
        out = jax.jit(lambda st, c=cfg: mpm.run(c, st, 150))(s)
        outs[m] = np.asarray(out.pos)
        assert np.isfinite(outs[m]).all(), m
    # dt=8e-5 and an identity-F start mean plastic effects accumulate slowly;
    # require strict divergence, not a large one.
    assert np.abs(outs["mud"] - outs["snow"]).max() > 0
    assert np.abs(outs["snow"] - outs["sand"]).max() > 0


def test_mpm_settles_under_gravity():
    cfg = mpm.MPMConfig(n=1024, seed=3)
    s = mpm.init(cfg)
    out = jax.jit(lambda st: mpm.run(cfg, st, 400))(s)
    pos = np.asarray(out.pos)
    assert pos[:, 1].mean() < float(s.pos[:, 1].mean())
    # Jp stays in its clamp range
    Jp = np.asarray(out.Jp)
    assert (Jp >= 0.05).all() and (Jp <= 20.0).all()


def test_flip_matches_loop_oracle_f64():
    """Full-pipeline cross-check vs the per-particle float64 oracle
    (tests/oracles/flip_apic_oracle.py)."""
    from tests.oracles.flip_apic_oracle import FlipOracle

    cfg = fa.FlipApicConfig(particles=1024, grid=32, jacobi=12,
                            dtype="float64")
    s = fa.init(cfg)
    orc = FlipOracle(cfg, np.asarray(s.pos), np.asarray(s.vel),
                     np.asarray(s.affine_x), np.asarray(s.affine_y))
    step = jax.jit(lambda st: fa.step(cfg, st))
    for _ in range(5):
        s = step(s)
        orc.step()
    assert np.abs(np.asarray(s.pos) - orc.pos).max() < 1e-12
    assert np.abs(np.asarray(s.vel) - orc.vel).max() < 1e-12
    np.testing.assert_array_equal(np.asarray(s.density), orc.density)


@pytest.mark.parametrize("material", ["snow", "mud", "sand"])
def test_mpm_matches_loop_oracle_f64(material):
    """Full-pipeline cross-check vs the per-particle float64 oracle
    (tests/oracles/mpm_oracle.py), all three material laws."""
    from tests.oracles.mpm_oracle import MPMOracle

    cfg = mpm.MPMConfig(n=512, gx=32, gy=32, material=material,
                        dtype="float64")
    s = mpm.init(cfg)
    orc = MPMOracle(cfg, np.asarray(s.pos), np.asarray(s.vel),
                    np.asarray(s.F), np.asarray(s.Jp))
    step = jax.jit(lambda st: mpm.step(cfg, st))
    for _ in range(5):
        s = step(s)
        orc.step()
    assert np.abs(np.asarray(s.pos) - orc.pos).max() < 1e-12
    assert np.abs(np.asarray(s.vel) - orc.vel).max() < 1e-12
    assert np.abs(np.asarray(s.F) - orc.F).max() < 1e-12
    assert np.abs(np.asarray(s.Jp) - orc.Jp).max() < 1e-12


@pytest.mark.parametrize("solver", ["flip", "mpm"])
def test_dense_engine_matches_scatter_engine(solver):
    """The cell-dense transfers (binning + dense sums) and the reference's
    own atomic scatter/gather form agree to f32 summation order while no
    cell overflows its capacity."""
    if solver == "flip":
        base = fa.FlipApicConfig(particles=4096, grid=32, jacobi=8)
        mod = fa
    else:
        base = mpm.MPMConfig(n=4096, gx=48, gy=48)
        mod = mpm
    s0 = mod.init(base)
    a = jax.jit(lambda s: mod.run(base.replace(engine="dense"), s, 3))(s0)
    b = jax.jit(lambda s: mod.run(base.replace(engine="scatter"), s, 3))(s0)
    assert int(mod.overflow_count(base.replace(engine="dense"), a)) == 0
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("make", [fa.FlipApicConfig, mpm.MPMConfig])
@pytest.mark.parametrize("engine", ["pallas", "auto"])
def test_removed_engine_values_raise_config_error(make, engine):
    from fluidsims_tpu.core.config import ConfigError

    with pytest.raises(ConfigError):
        make(engine=engine)


@pytest.mark.parametrize("engine", ["dense", "scatter"])
def test_mpm_matrix_products_run_at_highest_precision(engine):
    """Every 2x2 matrix product of the MPM step is pinned to HIGHEST
    precision, so on a GPU a float32 einsum never drops to TF32; and the
    float32 step then tracks the float64 step to float32 rounding."""
    from jax.extend import core as jcore

    cfg = mpm.MPMConfig(n=2048, gx=32, gy=32, engine=engine)
    s = mpm.init(cfg)

    def precisions(jaxpr, out):
        for e in jaxpr.eqns:
            if e.primitive.name == "dot_general":
                out.append(e.params["precision"])
            for v in e.params.values():
                if isinstance(v, jcore.ClosedJaxpr):
                    precisions(v.jaxpr, out)
                elif isinstance(v, jcore.Jaxpr):
                    precisions(v, out)
        return out

    found = precisions(jax.make_jaxpr(lambda st: mpm.step(cfg, st))(s).jaxpr,
                       [])
    assert found and all(p == (jax.lax.Precision.HIGHEST,) * 2
                         for p in found), found

    cfg64 = cfg.replace(dtype="float64")
    s64 = mpm.init(cfg64)
    a = jax.jit(lambda st: mpm.run(cfg, st, 3))(s)
    b = jax.jit(lambda st: mpm.run(cfg64, st, 3))(s64)
    np.testing.assert_allclose(np.asarray(a.F), np.asarray(b.F),
                               rtol=0, atol=1e-5)


def test_resident_engine_matches_dense():
    """The resident-slab engine (solvers/flip_resident.py, the documented
    negative result) must still be CORRECT: same trajectory as the dense
    engine to f32 summation-order tolerance, exact binning round-trip,
    zero loss, and an exactly matching density raster."""
    import jax

    from fluidsims_tpu.solvers import flip_resident as fr

    cfg = fa.FlipApicConfig(particles=4096, grid=32, jacobi=8,
                            engine="dense")
    s0 = fa.init(cfg)

    rt = fr.to_flat(cfg, fr.to_resident(cfg, s0))
    np.testing.assert_array_equal(np.asarray(rt.pos), np.asarray(s0.pos))
    np.testing.assert_array_equal(np.asarray(rt.vel), np.asarray(s0.vel))

    out, lost = jax.jit(lambda s: fr.run_resident(cfg, s, 20))(s0)
    ref = jax.jit(lambda s: fa.run(cfg, s, 20))(s0)
    assert int(lost) == 0
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               rtol=0, atol=3e-4)
    assert int(np.asarray(out.density).sum()) == cfg.particles


def test_resident_engine_homeless_recovery():
    """Movers into a full cell wait frozen in the homeless buffer and are
    re-inserted when room appears; particles are never silently dropped
    (lost counts only true buffer overruns)."""
    import jax

    from fluidsims_tpu.solvers import flip_resident as fr

    # tiny capacity forces overflow at init: K slots per cell, the rest
    # start homeless
    cfg = fa.FlipApicConfig(particles=2048, grid=16, jacobi=4,
                            engine="dense", bin_capacity=8)
    s0 = fa.init(cfg)
    r0 = fr.to_resident(cfg, s0)
    n_home0 = int((np.asarray(r0.homeless[:, 9]) >= 0).sum())
    assert n_home0 > 0  # the clustered block overflows K=8 somewhere

    out = jax.jit(lambda st: fr.step_resident(cfg, st))(r0)
    ids = np.asarray(out.ids)
    hid = np.asarray(out.homeless[:, 9])
    n_total = (ids >= 0).sum() + (hid >= 0).sum() + int(out.lost)
    assert n_total == cfg.particles  # full accounting, nothing vanishes
