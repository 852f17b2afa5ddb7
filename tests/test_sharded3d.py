"""3-D multi-chip equivalence: z-slab sharded hypersonic3d must reproduce
the dense single-chip run."""

import jax
import numpy as np
import pytest

from fluidsims_tpu.parallel import hypersonic3d_sharded as sh3
from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import hypersonic3d as h3

N_STEPS = 4


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded3d_matches_dense(n_dev):
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = h3.default_config(24)
    dense = h3.init(cfg)
    dense_out = jax.jit(lambda s: h3.run(cfg, s, N_STEPS))(dense)

    mesh = make_mesh_1d(n_dev, axis="z")
    state = sh3.shard_state(h3.init(cfg), mesh)
    run = sh3.make_sharded_run(cfg, mesh, N_STEPS)
    out = run(state)

    for name in ("xi", "phix", "phiy", "phiz", "lam", "zet"):
        a = np.asarray(getattr(out, name))
        b = np.asarray(getattr(dense_out, name))
        np.testing.assert_allclose(a, b, rtol=3e-6, atol=3e-6, err_msg=name)
    np.testing.assert_allclose(float(out.t), float(dense_out.t), rtol=1e-6)
    np.testing.assert_allclose(float(out.dtau), float(dense_out.dtau),
                               rtol=1e-6)


def test_sharded3d_rejects_bad_split():
    mesh = make_mesh_1d(4, axis="z")
    with pytest.raises(ValueError):
        sh3.make_sharded_run(h3.default_config(18), mesh, 1)
    with pytest.raises(ValueError):  # slab thinner than 2*halo
        sh3.make_sharded_run(h3.default_config(16), mesh, 1)
