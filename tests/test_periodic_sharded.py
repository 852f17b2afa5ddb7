"""Generic periodic x-slab sharding: Gray–Scott and LBM across 8 virtual
devices must match the dense single-device run exactly."""

import jax
import numpy as np
import pytest

from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.parallel.periodic_sharded import (
    make_sharded_periodic_run, shard_arrays)
from fluidsims_tpu.solvers import gray_scott as gs
from fluidsims_tpu.solvers import lbm

N_STEPS = 7


@pytest.mark.parametrize("n_dev", [2, 8])
def test_gray_scott_sharded_matches_dense(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = gs.GrayScottConfig(nx=64, ny=32)
    s = gs.init(cfg)
    dense = gs.run(cfg, s, N_STEPS)

    mesh = make_mesh_1d(n_dev)
    nxl = cfg.nx // n_dev + 2  # extended slab width seen by local_step
    cfg_ext = gs.GrayScottConfig(nx=nxl, ny=cfg.ny, dx=cfg.dx, dt=cfg.dt,
                                 Du=cfg.Du, Dv=cfg.Dv, feed=cfg.feed,
                                 kill=cfg.kill)

    def local(ext):
        u, v = ext
        out = gs.step(cfg_ext, gs.GrayScottState(u=u, v=v))
        return (out.u, out.v)

    run = make_sharded_periodic_run(local, mesh, halo=1, n_steps=N_STEPS)
    u, v = run(shard_arrays((s.u, s.v), mesh))
    np.testing.assert_allclose(np.asarray(u), np.asarray(dense.u),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(v), np.asarray(dense.v),
                               rtol=1e-6, atol=1e-7)


def test_lbm_sharded_matches_dense():
    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = lbm.LBMConfig(nx=64, ny=32, obstacle=False, drive=1e-4)
    s = lbm.init(cfg)
    dense = lbm.run(cfg, s, N_STEPS)

    mesh = make_mesh_1d(n_dev)
    nxl = cfg.nx // n_dev + 2
    cfg_ext = lbm.LBMConfig(nx=nxl, ny=cfg.ny, tau=cfg.tau, drive=cfg.drive,
                            obstacle=False)

    def local(ext):
        f, solid = ext
        out = lbm.step(cfg_ext, lbm.LBMState(f=f, solid=solid > 0.5))
        return (out.f, out.solid.astype(f.dtype))

    run = make_sharded_periodic_run(local, mesh, halo=1, n_steps=N_STEPS)
    f, _ = run(shard_arrays((s.f, s.solid.astype(s.f.dtype)), mesh))
    np.testing.assert_allclose(np.asarray(f), np.asarray(dense.f),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_burgers_sharded_matches_dense(n_dev):
    from fluidsims_tpu.parallel.tau_sharded import (
        make_sharded_burgers_run, shard_burgers)
    from fluidsims_tpu.solvers import burgers as bg

    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    for muscl in (False, True):
        cfg = bg.BurgersConfig(nx=64, ny=32, muscl=muscl, visc_substeps=2)
        s = bg.init(cfg)
        dense = bg.run(cfg, s, N_STEPS)
        run = make_sharded_burgers_run(cfg, make_mesh_1d(n_dev), N_STEPS)
        out = run(shard_burgers(s, make_mesh_1d(n_dev)))
        np.testing.assert_array_equal(np.asarray(out.phi_u),
                                      np.asarray(dense.phi_u),
                                      err_msg=f"muscl={muscl}")
        np.testing.assert_array_equal(np.asarray(out.phi_v),
                                      np.asarray(dense.phi_v))
        np.testing.assert_allclose(float(out.t), float(dense.t), rtol=1e-12)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shallow_water_sharded_matches_dense(n_dev):
    from fluidsims_tpu.parallel.tau_sharded import (
        make_sharded_shallow_water_run, shard_shallow_water)
    from fluidsims_tpu.solvers import shallow_water as sw

    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = sw.ShallowWaterConfig(nx=64, ny=32)
    s = sw.init(cfg)
    dense = sw.run(cfg, s, N_STEPS)
    run = make_sharded_shallow_water_run(cfg, make_mesh_1d(n_dev), N_STEPS)
    out = run(shard_shallow_water(s, make_mesh_1d(n_dev)))
    for name in ("sigma", "u", "v"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name)),
                                      np.asarray(getattr(dense, name)),
                                      err_msg=name)
    np.testing.assert_allclose(float(out.t), float(dense.t), rtol=1e-12)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mhd_sharded_matches_dense(n_dev):
    from fluidsims_tpu.parallel import mhd_sharded as msh
    from fluidsims_tpu.solvers import mhd

    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    # stable flux + orszag-tang (periodic-style IC on the clamped domain)
    cfg = mhd.MHDConfig(nx=64, ny=44, problem="orszag-tang", stable_hll=True)
    s = mhd.init(cfg)
    dense = mhd.run(cfg, s, N_STEPS)
    mesh = make_mesh_1d(n_dev)
    out = msh.make_sharded_run(cfg, mesh, N_STEPS)(msh.shard_state(s, mesh))
    for name in mhd.ConsM._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(out.U, name)),
            np.asarray(getattr(dense.U, name)), err_msg=name)
    np.testing.assert_allclose(float(out.t), float(dense.t), rtol=1e-12)


@pytest.mark.parametrize("n_dev", [4])
def test_gray_scott_comm_avoiding_multistep(n_dev):
    """Communication-avoiding composition (periodic_sharded.py module doc):
    halo=K + a K-step local body pays ONE ppermute per K steps, and must
    match the dense run."""
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    K, n_sup = 4, 3
    cfg = gs.GrayScottConfig(nx=480, ny=32)
    s = gs.init(cfg)
    dense = gs.run(cfg, s, K * n_sup)

    mesh = make_mesh_1d(n_dev)
    nxl = cfg.nx // n_dev + 2 * K
    cfg_ext = gs.GrayScottConfig(nx=nxl, ny=cfg.ny, dx=cfg.dx, dt=cfg.dt,
                                 Du=cfg.Du, Dv=cfg.Dv, feed=cfg.feed,
                                 kill=cfg.kill)

    # (a) XLA K-step local body: corruption creeps 1 col/step into the
    # K-deep halo, which is cropped after each superstep
    def local_xla(ext):
        st = gs.GrayScottState(u=ext[0], v=ext[1])
        for _ in range(K):
            st = gs.step(cfg_ext, st)
        return (st.u, st.v)

    run = make_sharded_periodic_run(local_xla, mesh, halo=K, n_steps=n_sup)
    u, v = run(shard_arrays((s.u, s.v), mesh))
    np.testing.assert_allclose(np.asarray(u), np.asarray(dense.u),
                               rtol=1e-6, atol=1e-7)
