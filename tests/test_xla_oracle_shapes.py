"""Each solver's plain XLA step against its float64 loop oracle at the
awkward shapes: widths that are not powers of two or multiples of 128,
odd row counts, and the wide flagship strip.  The compiled GPU step is
the same XLA program, so these pin the shapes the accelerator runs."""

import jax
import numpy as np
import pytest

from fluidsims_tpu.solvers import burgers as bg
from fluidsims_tpu.solvers import gray_scott as gs
from fluidsims_tpu.solvers import hypersonic2d as h2
from fluidsims_tpu.solvers import lbm
from fluidsims_tpu.solvers import mhd
from fluidsims_tpu.solvers import shallow_water as sw
from fluidsims_tpu.solvers import stam2d
from fluidsims_tpu.solvers import stam3d


def _run(step_fn, s, n):
    step = jax.jit(step_fn)
    for _ in range(n):
        s = step(s)
    return s


def _gray_scott(nx, ny):
    from tests.oracles.gray_scott_oracle import GrayScottOracle

    cfg = gs.GrayScottConfig(nx=nx, ny=ny, feed=0.0367, kill=0.0649,
                             dtype="float64")
    s = gs.init(cfg)
    orc = GrayScottOracle(cfg, np.asarray(s.u), np.asarray(s.v))
    s = _run(lambda st: gs.step(cfg, st), s, 3)
    for _ in range(3):
        orc.step()
    return [(s.u, orc.u), (s.v, orc.v)], 1e-13


def _lbm(nx, ny):
    from tests.oracles.lbm_oracle import LBMOracle

    cfg = lbm.LBMConfig(nx=nx, ny=ny, drive=1e-4, obstacle_radius=ny / 8,
                        dtype="float64")
    s = lbm.init(cfg)
    orc = LBMOracle(cfg, np.asarray(s.f), np.asarray(s.solid))
    s = _run(lambda st: lbm.step(cfg, st), s, 3)
    for _ in range(3):
        orc.step()
    return [(s.f, orc.f)], 1e-13


def _burgers(nx, ny):
    from tests.oracles.burgers_oracle import BurgersOracle

    cfg = bg.BurgersConfig(nx=nx, ny=ny, dtau=1e-2, dtype="float64")
    s = bg.init(cfg)
    orc = BurgersOracle(cfg, np.asarray(s.phi_u), np.asarray(s.phi_v),
                        float(s.t), float(s.tau))
    s = _run(lambda st: bg.step(cfg, st), s, 2)
    for _ in range(2):
        orc.step()
    return [(s.phi_u, orc.pu), (s.phi_v, orc.pv)], 1e-12


def _shallow_water(nx, ny):
    from tests.oracles.shallow_water_oracle import SWOracle

    cfg = sw.ShallowWaterConfig(nx=nx, ny=ny, dtau=1e-3, dtype="float64")
    s = sw.init(cfg)
    orc = SWOracle(cfg, np.asarray(s.sigma), np.asarray(s.u),
                   np.asarray(s.v), float(s.t), float(s.tau))
    s = _run(lambda st: sw.step(cfg, st), s, 2)
    for _ in range(2):
        orc.step()
    return [(s.sigma, orc.sigma), (s.u, orc.u), (s.v, orc.v)], 1e-12


def _mhd(nx, ny):
    from tests.oracles.mhd_oracle import MHDOracle

    cfg = mhd.MHDConfig(nx=nx, ny=ny, problem="orszag-tang",
                        dtype="float64")
    s = mhd.init(cfg)
    orc = MHDOracle(cfg, tuple(s.U), float(s.t))
    s = _run(lambda st: mhd.step(cfg, st), s, 2)
    for _ in range(2):
        orc.step()
    got = np.stack([np.asarray(f) for f in s.U], -1)
    return [(got, orc.U)], 1e-12


def _hypersonic2d(nx, ny):
    from tests.oracles import hypersonic2d_oracle as oracle

    cfg = h2.Hypersonic2DConfig(nx=nx, ny=ny, geom_x0=nx / 8.0,
                                geom_cy=ny / 2.0, geom_Rb=ny / 12.0,
                                geom_Rn=ny / 24.0, dtype="float64")
    ocfg = oracle.Cfg(nx=nx, ny=ny)
    s = h2.init(cfg)
    oU, omask = oracle.init(ocfg)
    s = _run(lambda st: h2.step(cfg, st), s, 3)
    for _ in range(3):
        oU, _ = oracle.step(ocfg, oU, omask)
    got = np.stack([np.asarray(f) for f in s.U], -1)
    fl = ~omask
    return [(got[fl], oU[fl])], 1e-10


def _stam2d(n, _):
    from tests.oracles.stam2d_oracle import Stam2DOracle

    cfg = stam2d.Stam2DConfig(n=n, jacobi_iters=6, dtype="float64")
    s = stam2d.init(cfg)
    orc = Stam2DOracle(cfg, np.asarray(s.u), np.asarray(s.v),
                       np.asarray(s.u0), np.asarray(s.v0),
                       np.asarray(s.d), np.asarray(s.d0), int(s.step_idx))
    s = _run(lambda st: stam2d.step(cfg, st), s, 2)
    for _ in range(2):
        orc.step()
    return [(getattr(s, k), getattr(orc, k)[1:-1, 1:-1])
            for k in ("u", "v", "d")], 1e-12


def _stam3d(n, _):
    from tests.oracles.stam3d_oracle import Stam3DOracle

    cfg = stam3d.Stam3DConfig(n=n, jacobi_iters=4, advect_k=0,
                              dtype="float64")
    s = stam3d.init(cfg)
    orc = Stam3DOracle(cfg, *[np.asarray(getattr(s, f)) for f in
                              ("u", "v", "w", "u0", "v0", "w0", "d", "d0")],
                       int(s.step_idx))
    s = _run(lambda st: stam3d.step(cfg, st), s, 1)
    orc.step()
    return [(getattr(s, k), getattr(orc, k)) for k in ("u", "w", "d")], 1e-12


CASES = {
    "gray_scott-48x32": (_gray_scott, 48, 32),
    "gray_scott-100x64": (_gray_scott, 100, 64),
    "gray_scott-136x40": (_gray_scott, 136, 40),
    "lbm-64x32": (_lbm, 64, 32),
    "lbm-100x48": (_lbm, 100, 48),
    "burgers-72x40": (_burgers, 72, 40),
    "burgers-44x33": (_burgers, 44, 33),
    "shallow_water-72x40": (_shallow_water, 72, 40),
    "shallow_water-44x33": (_shallow_water, 44, 33),
    "mhd-52x36": (_mhd, 52, 36),
    "hypersonic2d-64x32": (_hypersonic2d, 64, 32),
    "hypersonic2d-128x32": (_hypersonic2d, 128, 32),
    "hypersonic2d-64x30": (_hypersonic2d, 64, 30),
    "stam2d-48": (_stam2d, 48, None),
    "stam3d-10": (_stam3d, 10, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_step_matches_f64_oracle(case):
    fn, a, b = CASES[case]
    pairs, tol = fn(a, b)
    for got, ref in pairs:
        err = np.abs(np.asarray(got, np.float64) - ref).max()
        assert err < tol, (case, err)
