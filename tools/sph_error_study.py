#!/usr/bin/env python
"""Quantify the SPH fast path's dropped-pair error at the reference defaults.

The cell-dense engine (xla) drops pair interactions beyond K
particles per cell; the reference's linked lists never drop
(tau_sph.cu:165-176).  At the reference's own defaults (c0=1, gamma=1,
g=9.81 — NOT weakly compressible, see solvers/sph.py CAVEAT) the settled
pool exceeds K by ~9x, so the headline particle metric is measured in the
dropped-pairs regime.  This study makes that trade a number (VERDICT r4
weak #4): run `--steps` steps at the defaults on the fast engine and on
engine='exact' (all pairs, any occupancy), and at each checkpoint report

  * rel-L2 of the SPH density field rho(x) = sum_j m W(|x-x_j|) evaluated
    on a raster of grid centers (the field the renderer shows);
  * rel-L2 of the Tait pressure field on the same raster;
  * per-particle position divergence (mean / p95 |dx| over the box
    diagonal — particle ids correspond 1:1 across engines, every source
    of randomness is the same deterministic LCG/seed);
  * the horizontally-averaged density profile rho(y) (the hydrostatic
    observable that is statistically stable even when trajectories
    decorrelate).

CONTROL: the same metrics for exact-vs-exact with the initial positions
perturbed by 1e-6*spacing.  These defaults are chaotic (a settled pool
under g with c0=1), so individual trajectories decorrelate from ANY
perturbation; the control is the chaos floor.  Fast-engine error above
the control is attributable to the dropped pairs; error at the control
level means the fast path is statistically as good as an
infinitesimally-perturbed exact run.

Writes SPH_ERROR.json at the repo root and prints one JSON line per
checkpoint.  Run on the GPU; --n/--steps shrink it for CPU smoke use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def density_field(cfg, pos, W=64, H=64, chunk=4096):
    """Exact SPH density at WxH raster cell centers (the unbounded-neighbor
    field both engines are trying to produce) — solvers.sph.raster_density,
    shared with the gate test (tests/test_sph.py)."""
    import jax

    from fluidsims_tpu.solvers.sph import raster_density

    return jax.device_get(raster_density(cfg, pos, W, H, chunk))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--engine", default="xla",
                    help="fast engine to compare against exact")
    ap.add_argument("--out", default=os.path.join(ROOT, "SPH_ERROR.json"))
    args = ap.parse_args()

    import jax

    from fluidsims_tpu.core.platform import enable_compile_cache

    enable_compile_cache(jax)
    import numpy as np

    from fluidsims_tpu.core.stepper import scan_steps
    from fluidsims_tpu.solvers import sph
    from fluidsims_tpu.solvers.sph import tait_pressure

    cfg_fast = sph.SPHConfig(n=args.n, engine=args.engine)
    cfg_ex = sph.SPHConfig(n=args.n, engine="exact")
    engine = cfg_fast.engine
    grid = cfg_fast.grid()
    print(f"# engine={engine} K={grid.K} cells={grid.Gx}x{grid.Gy} "
          f"n={args.n}", file=sys.stderr)

    run_fast = jax.jit(
        lambda s: scan_steps(lambda x: sph.step(cfg_fast, x), s, args.every))
    run_ex = jax.jit(
        lambda s: scan_steps(lambda x: sph.step(cfg_ex, x), s, args.every))

    st_f = sph.init(cfg_fast)
    st_e = sph.init(cfg_ex)
    # control: exact engine from an infinitesimally-perturbed init (the
    # chaos floor every engine comparison sits on top of)
    st_c = sph.init(cfg_ex)
    import jax.numpy as jnp

    # 1e-4*spacing on every particle: must survive f32 rounding against
    # O(box) coordinates, and seeding all particles makes the divergence
    # rate engine-global rather than gated on one particle's neighborhood
    rng = np.random.default_rng(0)
    bump = jnp.asarray(
        (rng.random(st_c.pos.shape) - 0.5) * 2e-4 * cfg_ex.spacing,
        st_c.pos.dtype)
    st_c = st_c._replace(pos=st_c.pos + bump)

    diag = float(np.hypot(cfg_fast.box_x, cfg_fast.box_y))
    records = []
    for ck in range(args.every, args.steps + 1, args.every):
        st_f = run_fast(st_f)
        st_e = run_ex(st_e)
        st_c = run_ex(st_c)
        pos_f = np.asarray(jax.device_get(st_f.pos))
        pos_e = np.asarray(jax.device_get(st_e.pos))
        pos_c = np.asarray(jax.device_get(st_c.pos))
        rho_f = density_field(cfg_fast, st_f.pos)
        rho_e = density_field(cfg_ex, st_e.pos)
        rho_c = density_field(cfg_ex, st_c.pos)
        p_f = np.asarray(tait_pressure(cfg_fast, rho_f))
        p_e = np.asarray(tait_pressure(cfg_ex, rho_e))
        p_c = np.asarray(tait_pressure(cfg_ex, rho_c))

        def rel_l2(a, b):
            return float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                     1e-30))

        def pos_metrics(a, b):
            d = np.linalg.norm(a - b, axis=1) / diag
            return (round(float(d.mean()), 6),
                    round(float(np.percentile(d, 95)), 6))

        def profile(rho):
            return rho.mean(axis=1)  # horizontal average -> rho(y)

        pm_f, pp_f = pos_metrics(pos_f, pos_e)
        pm_c, pp_c = pos_metrics(pos_c, pos_e)
        ovf = int(jax.device_get(sph.overflow_count(cfg_fast, st_f)))
        rec = {
            "step": ck,
            "rho_field_rel_l2": round(rel_l2(rho_f, rho_e), 6),
            "press_field_rel_l2": round(rel_l2(p_f, p_e), 6),
            "rho_profile_rel_l2": round(rel_l2(profile(rho_f),
                                               profile(rho_e)), 6),
            "pos_mean_over_diag": pm_f,
            "pos_p95_over_diag": pp_f,
            "overflow_count": ovf,
            "control": {
                "rho_field_rel_l2": round(rel_l2(rho_c, rho_e), 6),
                "press_field_rel_l2": round(rel_l2(p_c, p_e), 6),
                "rho_profile_rel_l2": round(rel_l2(profile(rho_c),
                                                   profile(rho_e)), 6),
                "pos_mean_over_diag": pm_c,
                "pos_p95_over_diag": pp_c,
            },
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)

    out = {"engine": engine, "n": args.n, "K": int(grid.K),
           "defaults": "tau_sph.cu (c0=1, gamma=1, g=9.81, rain on)",
           "checkpoints": records}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
