"""Multi-chip equivalence: the sharded x-slab hypersonic step must reproduce
the single-chip result exactly (SURVEY.md §7 phase 6 requirement)."""

import jax
import numpy as np
import pytest

from fluidsims_tpu.parallel import hypersonic2d_sharded as sh
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import hypersonic2d as h2

N_STEPS = 5


def cfg_for(nx=64, ny=32, dtype="float32"):
    return h2.Hypersonic2DConfig(
        nx=nx, ny=ny, geom_x0=nx / 8.0, geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0, geom_Rn=ny / 24.0, dtype=dtype,
    )


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_matches_dense(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = cfg_for()
    dense = h2.init(cfg)
    dense_out = jax.jit(lambda s: h2.run(cfg, s, N_STEPS))(dense)

    mesh = make_mesh_1d(n_dev)
    state = sh.shard_state(h2.init(cfg), mesh)
    run = sh.make_sharded_run(cfg, mesh, N_STEPS)
    out = run(state)

    for a, b, name in zip(out.U, dense_out.U, ("rho", "mx", "my", "E")):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-6, atol=2e-6, err_msg=name
        )
    np.testing.assert_allclose(float(out.t), float(dense_out.t), rtol=1e-6)


def test_sharded_rejects_indivisible():
    cfg = cfg_for(nx=60)
    mesh = make_mesh_1d(8)
    with pytest.raises(ValueError):
        sh.make_sharded_run(cfg, mesh, 1)


@pytest.mark.parametrize("py,px", [(2, 2), (2, 4), (4, 2)])
def test_hypersonic2d_mesh2d_matches_dense(py, px):
    """(x, y) device-grid decomposition matches the dense run exactly."""
    from fluidsims_tpu.parallel import hypersonic2d_sharded2d as sh2

    if len(jax.devices()) < px * py:
        pytest.skip("not enough devices")
    ny, nx = 32, 64
    cfg = h2.Hypersonic2DConfig(
        nx=nx, ny=ny, geom_x0=nx / 8.0, geom_cy=ny / 2.0,
        geom_Rb=ny / 12.0, geom_Rn=ny / 24.0,
    )
    s = h2.init(cfg)
    # jitted reference: eager-mode stepping rounds differently (1 ulp near
    # the wall ghosts) than compiled fusion
    dense = jax.jit(lambda st: h2.run(cfg, st, N_STEPS))(s)

    mesh = sh2.make_mesh_2d(px, py)
    out = sh2.make_sharded_run(cfg, mesh, N_STEPS)(sh2.shard_state(s, mesh))
    # ulp-scale tolerance: the halo-extend+crop construction is exact, but
    # XLA's shape-dependent fusion (FMA contraction) can round the same
    # elementwise graph differently for different local-slab shapes — the
    # same ~1-ulp drift seen between eager and jitted dense runs
    for f, g, name in zip(out.U, dense.U, ("rho", "mx", "my", "E")):
        fa, ga = np.asarray(f), np.asarray(g)
        scale = np.maximum(np.abs(ga), 1.0)
        assert (np.abs(fa - ga) / scale).max() < 1e-5, f"{name} {py}x{px}"
    np.testing.assert_allclose(float(out.t), float(dense.t), rtol=1e-10)
