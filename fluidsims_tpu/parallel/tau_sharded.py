"""Multi-device τ-clock periodic solvers: Burgers + shallow water x-slabs.

Both solvers are fully periodic shift-stencil updates with one global CFL
reduction and a replicated scalar clock, so they share one pattern
(SURVEY.md §5, the cross-device analog of the single-GPU whole-grid
reductions in
tau_burgers.cu:337-362 / tau_shallow_water.cu:394-423):

  * shard the (ny, nx) fields along x over a 1-D mesh;
  * each step, ring-exchange `halo` columns with lax.ppermute (the ring IS
    the periodic wrap) and run the unmodified dense step on the extended
    slab — its built-in wrap only corrupts the halo columns, which are
    cropped;
  * the CFL max runs through lax.pmax (`wavespeed_reduce` hook), so every
    device advances with the identical dt and the multi-chip trajectory is
    bitwise that of the single chip (asserted in
    tests/test_periodic_sharded.py).

Halo widths (stencil reach of one step):
  * Burgers: faces reach 1 (2 with MUSCL slopes), plus 1 per viscosity
    substep chained through the update.
  * Shallow water: faces reach 1, plus 2 when viscosity is enabled (the
    Laplacian reads the already-updated velocity).
"""

from __future__ import annotations

import functools

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers import burgers as bg
from ..solvers import shallow_water as sw
from .periodic_sharded import exchange_periodic_x

__all__ = ["burgers_halo", "shallow_water_halo", "shard_burgers",
           "shard_shallow_water", "make_sharded_burgers_run",
           "make_sharded_shallow_water_run"]


def burgers_halo(cfg: bg.BurgersConfig) -> int:
    return (2 if cfg.muscl else 1) + cfg.visc_substeps


def shallow_water_halo(cfg: sw.ShallowWaterConfig) -> int:
    return 1 + (2 if cfg.nu > 0.0 else 0)


def _shard_fields_scalars(state, n_fields: int, mesh: Mesh, axis: str):
    field_sh = NamedSharding(mesh, P(None, axis))
    scalar_sh = NamedSharding(mesh, P())
    parts = [
        jax.device_put(f, field_sh if i < n_fields else scalar_sh)
        for i, f in enumerate(state)
    ]
    return type(state)(*parts)


def shard_burgers(state: bg.BurgersState, mesh: Mesh, axis: str = "x"):
    return _shard_fields_scalars(state, 2, mesh, axis)


def shard_shallow_water(state: sw.ShallowWaterState, mesh: Mesh,
                        axis: str = "x"):
    return _shard_fields_scalars(state, 3, mesh, axis)


def _make_run(step_fn, state_cls, n_fields: int, halo: int, mesh: Mesh,
              nx: int, n_steps: int, axis: str):
    n_dev = mesh.shape[axis]
    if nx % n_dev:
        raise ValueError(f"nx={nx} not divisible by {n_dev} devices")
    if nx // n_dev < halo:
        raise ValueError(
            f"local slab {nx // n_dev} thinner than halo {halo}")

    def body(*parts):
        fields = parts[:n_fields]
        scalars = parts[n_fields:]

        def one(carry, _):
            fs, sc = carry
            ext = tuple(
                exchange_periodic_x(f, halo, axis, n_dev) for f in fs
            )
            out = step_fn(
                state_cls(*ext, *sc),
                wavespeed_reduce=lambda v: lax.pmax(v, axis),
            )
            new_fields = tuple(f[..., halo:-halo] for f in out[:n_fields])
            return (new_fields, tuple(out[n_fields:])), None

        (fields, scalars), _ = lax.scan(
            one, (tuple(fields), tuple(scalars)), None, length=n_steps)
        return (*fields, *scalars)

    field_spec = P(None, axis)
    in_specs = tuple([field_spec] * n_fields
                     + [P()] * (len(state_cls._fields) - n_fields))
    sharded = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                            out_specs=in_specs, check_vma=False)

    @jax.jit
    def run(state):
        return state_cls(*sharded(*state))

    return run


def make_sharded_burgers_run(cfg: bg.BurgersConfig, mesh: Mesh,
                             n_steps: int, axis: str = "x"):
    step = functools.partial(bg.step, cfg)
    return _make_run(lambda s, **kw: step(s, **kw), bg.BurgersState, 2,
                     burgers_halo(cfg), mesh, cfg.nx, n_steps, axis)


def make_sharded_shallow_water_run(cfg: sw.ShallowWaterConfig, mesh: Mesh,
                                   n_steps: int, axis: str = "x"):
    step = functools.partial(sw.step, cfg)
    return _make_run(lambda s, **kw: step(s, **kw), sw.ShallowWaterState, 3,
                     shallow_water_halo(cfg), mesh, cfg.nx, n_steps, axis)
