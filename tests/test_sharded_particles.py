"""Multi-chip particle solver: FLIP/APIC data-parallel particles +
replicated grid (parallel/flip_sharded.py), verified on the 8-virtual-
device CPU mesh against the single-chip trajectory."""

import jax
import numpy as np

from fluidsims_tpu.parallel import flip_sharded as fsh
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import flip_apic as fa


def _cfg(**kw):
    kw.setdefault("particles", 4096)
    kw.setdefault("grid", 32)
    kw.setdefault("jacobi", 8)
    return fa.FlipApicConfig(**kw)


def test_interleave_perm():
    perm = fsh.interleave_perm(12, 4)
    # block d owns original indices d::4
    assert list(perm[:3]) == [0, 4, 8]
    assert list(perm[3:6]) == [1, 5, 9]
    assert sorted(perm) == list(range(12))


def test_sharded_flip_matches_single_chip():
    """8-device particle-sharded run tracks the single-chip trajectory to
    f32 summation-order tolerance (per-device P2G partials + psum
    reassociate the grid sums)."""
    n_dev = 8
    cfg = _cfg()
    mesh = make_mesh_1d(n_dev, axis="p")
    s0 = fa.init(cfg)

    sharded = fsh.shard_state(s0, mesh)
    run = fsh.make_sharded_run(cfg, mesh, n_steps=5)
    out = run(sharded)

    ref = jax.jit(lambda s: fa.run(cfg, s, 5))(s0)

    perm = fsh.interleave_perm(cfg.particles, n_dev)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos)[perm], atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(out.vel), np.asarray(ref.vel)[perm], atol=3e-4)
    # density rasters agree except possibly for particles within FP noise
    # of a cell boundary
    dd = np.abs(np.asarray(out.density) - np.asarray(ref.density))
    assert dd.sum() <= 4
    assert int(np.asarray(out.density).sum()) == cfg.particles


def test_sharded_flip_scatter_engine():
    """The exact scatter engine composes with the particle sharding too."""
    n_dev = 4
    cfg = _cfg(particles=1024, grid=24, engine="scatter")
    mesh = make_mesh_1d(n_dev, axis="p")
    out = fsh.make_sharded_run(cfg, mesh, 3)(fsh.shard_state(fa.init(cfg),
                                                             mesh))
    ref = jax.jit(lambda s: fa.run(cfg, s, 3))(fa.init(cfg))
    perm = fsh.interleave_perm(cfg.particles, n_dev)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos)[perm], atol=3e-5)


def test_sharded_flip_capacity_scales_down():
    """Interleaved shards thin every cell, so the per-device cell-dense
    capacity (and with it per-device compute) drops with the device
    count."""
    from dataclasses import replace

    cfg = _cfg(particles=1 << 14, grid=64)
    local = replace(cfg, particles=cfg.particles // 8)
    assert local.capacity < cfg.capacity


def test_sharded_mpm_matches_single_chip():
    """MLS-MPM with the same particle-sharded + psum'd-grid design."""
    from fluidsims_tpu.parallel import mpm_sharded as msh
    from fluidsims_tpu.solvers import mpm

    n_dev = 8
    cfg = mpm.MPMConfig(n=4096, gx=48, gy=48)
    mesh = make_mesh_1d(n_dev, axis="p")
    out = msh.make_sharded_run(cfg, mesh, 5)(
        msh.shard_state(mpm.init(cfg), mesh))
    ref = jax.jit(lambda s: mpm.run(cfg, s, 5))(mpm.init(cfg))
    perm = fsh.interleave_perm(cfg.n, n_dev)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos)[perm], atol=3e-5)
    np.testing.assert_allclose(
        np.asarray(out.Jp), np.asarray(ref.Jp)[perm], rtol=2e-4)


def test_sharded_sph_matches_single_chip():
    """Cell-sharded SPH: every output column is computed by exactly one
    device with the same expressions as the one-device run; XLA may sum
    each column's pair terms in another order at another slab width, so
    the 8-device run agrees with the one-device run, and both with the
    cell-dense single-chip step, to f32 summation order (velocities are
    O(1): a few ulps per pair sum over 3 steps stays under 1e-5)."""
    from fluidsims_tpu.parallel import sph_sharded as ssh
    from fluidsims_tpu.solvers import sph

    cfg = sph.SPHConfig(n=16384, rain=True, dtau=1e-2)
    s0 = sph.init(cfg)

    def sharded(n_dev):
        mesh = make_mesh_1d(n_dev, axis="c")
        return ssh.make_sharded_run(cfg, mesh, 3)(ssh.shard_state(s0, mesh))

    ref = jax.jit(lambda s: sph.run(cfg, s, 3))(s0)
    out, one = sharded(8), sharded(1)
    for got in (out, ref):
        np.testing.assert_allclose(np.asarray(got.pos), np.asarray(one.pos),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got.vel), np.asarray(one.vel),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.tau), np.asarray(one.tau),
                                   rtol=1e-6)


def test_spatial_sph_matches_single_chip():
    """Spatially-sharded SPH (parallel/sph_spatial.py): distributed
    binning + x-slab ownership + ppermute halo bands + particle
    migration must reproduce the replicated-state runner on one device
    (compared by particle id; in-cell summation order differs, so
    short-horizon f32 tolerance)."""
    import numpy as np

    from fluidsims_tpu.parallel import sph_sharded as ssh
    from fluidsims_tpu.parallel import sph_spatial as ssp
    from fluidsims_tpu.solvers import sph

    cfg = sph.SPHConfig(n=16384, rain=False, dtau=1e-2)
    mesh = make_mesh_1d(8, axis="c")
    s0 = sph.init(cfg)
    st = ssp.shard_state(s0, cfg, mesh)
    out = ssp.make_sharded_run(cfg, mesh, 5)(st)
    assert int(out.lost) == 0
    pos, vel = ssp.gather_state(out, cfg.n)
    assert not np.isnan(pos).any()
    one = make_mesh_1d(1, axis="c")
    ref = ssh.make_sharded_run(cfg, one, 5)(ssh.shard_state(s0, one))
    np.testing.assert_allclose(pos, np.asarray(ref.pos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(out.t), float(ref.t), rtol=1e-6)


def test_spatial_sph_migrates_and_conserves_particles():
    """Long-horizon: particles change owners across slab boundaries, the
    fixed-capacity buffers never overflow at the default slack, and every
    particle stays tracked and inside the box."""
    import numpy as np

    from fluidsims_tpu.parallel import sph_spatial as ssp
    from fluidsims_tpu.solvers import sph

    cfg = sph.SPHConfig(n=16384, rain=False, dtau=1e-2)
    mesh = make_mesh_1d(8, axis="c")
    s0 = sph.init(cfg)
    st = ssp.shard_state(s0, cfg, mesh)
    ids0 = np.asarray(st.ids).reshape(8, -1)
    out = ssp.make_sharded_run(cfg, mesh, 40)(st)
    assert int(out.lost) == 0
    ids1 = np.asarray(out.ids).reshape(8, -1)
    moved = sum(len(set(ids1[d][ids1[d] >= 0].tolist())
                    - set(ids0[d][ids0[d] >= 0].tolist()))
                for d in range(8))
    assert moved > 100  # migration is actually exercised
    pos, vel = ssp.gather_state(out, cfg.n)
    assert not np.isnan(pos).any()
    assert (pos[:, 0] >= 0).all() and (pos[:, 0] <= cfg.box_x).all()
    assert (pos[:, 1] >= 0).all() and (pos[:, 1] <= cfg.box_y).all()
    # per-device memory is O(n/D): the owner buffers shard along the mesh
    shard = out.pos.sharding.shard_shape(out.pos.shape)
    assert shard[0] == out.pos.shape[0] // 8


def test_spatial_sph_rejects_rain_and_xsph():
    import pytest

    from fluidsims_tpu.parallel import sph_spatial as ssp
    from fluidsims_tpu.solvers import sph

    mesh = make_mesh_1d(8, axis="c")
    with pytest.raises(ValueError, match="rain"):
        ssp.make_sharded_run(sph.SPHConfig(n=16384, rain=True), mesh, 1)
    with pytest.raises(ValueError, match="XSPH"):
        ssp.make_sharded_run(
            sph.SPHConfig(n=16384, rain=False, use_xsph=True), mesh, 1)


def test_spatial_flip_matches_single_chip():
    """Spatially-sharded FLIP (parallel/flip_spatial.py): x-slab grid +
    particle ownership, ppermute halo reduce/fill, banded Jacobi and
    migration must reproduce the single-chip dense engine (compared by
    particle id; P2G summation order differs, so short-horizon f32
    tolerance)."""
    from fluidsims_tpu.core.stepper import scan_steps
    from fluidsims_tpu.parallel import flip_spatial as fsp

    cfg = _cfg(engine="dense")
    mesh = make_mesh_1d(8, axis="x")
    s0 = fa.init(cfg)
    st = fsp.shard_state(s0, cfg, mesh)
    out = fsp.make_sharded_run(cfg, mesh, 5)(st)
    assert int(out.lost) == 0
    pos, vel, ax, ay = fsp.gather_state(out, cfg.particles)
    assert not np.isnan(pos).any()
    ref = jax.jit(lambda s: scan_steps(
        lambda st_: fa.step(cfg, st_), s, 5))(s0)
    np.testing.assert_allclose(pos, np.asarray(ref.pos), rtol=0, atol=2e-5)
    np.testing.assert_allclose(vel, np.asarray(ref.vel), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ax, np.asarray(ref.affine_x), rtol=0,
                               atol=2e-2)  # affine = finite differences of
    np.testing.assert_allclose(ay, np.asarray(ref.affine_y), rtol=0,
                               atol=2e-2)  # p-noise-amplified samples
    # density raster agrees with the single-chip raster of the same pos
    dref = np.asarray(ref.density)
    np.testing.assert_array_equal(np.asarray(out.density), dref)


def test_spatial_flip_migrates_and_scales_memory():
    """Long-horizon: particles cross slab boundaries under the swirl,
    nothing is lost at the default slack, and the owner buffers shard."""
    from fluidsims_tpu.parallel import flip_spatial as fsp

    cfg = _cfg(engine="dense")
    mesh = make_mesh_1d(8, axis="x")
    s0 = fa.init(cfg)
    st = fsp.shard_state(s0, cfg, mesh)
    ids0 = np.asarray(st.ids).reshape(8, -1)
    out = fsp.make_sharded_run(cfg, mesh, 40)(st)
    assert int(out.lost) == 0
    ids1 = np.asarray(out.ids).reshape(8, -1)
    moved = sum(len(set(ids1[d][ids1[d] >= 0].tolist())
                    - set(ids0[d][ids0[d] >= 0].tolist()))
                for d in range(8))
    assert moved > 50  # migration is actually exercised
    pos, vel, _, _ = fsp.gather_state(out, cfg.particles)
    assert not np.isnan(pos).any()
    assert (pos >= 0.009).all() and (pos <= 0.991).all()
    shard = out.pos.sharding.shard_shape(out.pos.shape)
    assert shard[0] == out.pos.shape[0] // 8


def test_spatial_mpm_matches_single_chip():
    """Spatially-sharded MLS-MPM (parallel/mpm_spatial.py): x-slab grid +
    particle ownership, ppermute halo reduce/fill and migration must
    reproduce the single-chip dense engine (compared by particle id;
    P2G summation order differs, so short-horizon f32 tolerance)."""
    from fluidsims_tpu.parallel import mpm_spatial as msp
    from fluidsims_tpu.solvers import mpm

    cfg = mpm.MPMConfig(n=4096, gx=48, gy=48, engine="dense")
    mesh = make_mesh_1d(8, axis="x")
    s0 = mpm.init(cfg)
    st = msp.shard_state(s0, cfg, mesh)
    out = msp.make_sharded_run(cfg, mesh, 5)(st)
    assert int(out.lost) == 0
    got = msp.gather_state(out, cfg.n)
    assert not np.isnan(got.pos).any()
    ref = jax.jit(lambda s: mpm.run(cfg, s, 5))(s0)
    np.testing.assert_allclose(got.pos, np.asarray(ref.pos),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.vel, np.asarray(ref.vel),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.F, np.asarray(ref.F), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got.Jp, np.asarray(ref.Jp),
                               rtol=0, atol=2e-4)


def test_spatial_mpm_migrates_and_scales_memory():
    """Long-horizon: the shear-velocity block crosses slab boundaries,
    nothing is lost at the default slack, and the owner buffers shard."""
    from fluidsims_tpu.parallel import mpm_spatial as msp
    from fluidsims_tpu.solvers import mpm

    cfg = mpm.MPMConfig(n=4096, gx=48, gy=48, dt=4.0e-4, engine="dense")
    mesh = make_mesh_1d(8, axis="x")
    st = msp.shard_state(mpm.init(cfg), cfg, mesh)
    ids0 = np.asarray(st.ids).reshape(8, -1)
    out = msp.make_sharded_run(cfg, mesh, 300)(st)
    assert int(out.lost) == 0
    ids1 = np.asarray(out.ids).reshape(8, -1)
    moved = sum(len(set(ids1[d][ids1[d] >= 0].tolist())
                    - set(ids0[d][ids0[d] >= 0].tolist()))
                for d in range(8))
    assert moved > 50  # migration is actually exercised
    got = msp.gather_state(out, cfg.n)
    assert not np.isnan(got.pos).any()
    dx = cfg.dx
    assert (got.pos[:, 0] >= 2.0 * dx - 1e-6).all()
    assert (got.pos[:, 0] <= (cfg.gx - 3.0) * dx + 1e-6).all()
    shard = out.pos.sharding.shard_shape(out.pos.shape)
    assert shard[0] == out.pos.shape[0] // 8
