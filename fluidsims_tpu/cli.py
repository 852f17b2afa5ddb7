"""Command-line entry points — one subcommand per reference program.

Replaces the reference's per-program getopt mains with a single CLI that
keeps the headless benchmark contract first-class (SURVEY.md §5: the
interactive ncurses/raylib loops don't exist on headless hosts; --render gives
terminal frames, --steps/--stride the bench semantics, and the FPS/MLUPS
reports mirror js_cuda.cu:401-441 / tau_lbm.cu:291-294).

    python -m fluidsims_tpu.cli gray-scott --nx 256 --steps 2000
    python -m fluidsims_tpu.cli hypersonic2d --steps 100 --view schlieren
    python -m fluidsims_tpu.cli lbm --headless --steps 1000
    python -m fluidsims_tpu.cli th3cs --out vol.4spl --frames 60
"""

from __future__ import annotations

import argparse
import sys
import time


def _common(p, steps_default=200):
    p.add_argument("--steps", type=int, default=steps_default,
                   help="number of physics steps")
    p.add_argument("--stride", type=int, default=0,
                   help="render every N steps (0 = only final frame)")
    p.add_argument("--render", action="store_true",
                   help="print terminal frames")
    p.add_argument("--headless", action="store_true",
                   help="benchmark mode (no rendering)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--save-state", default=None, metavar="FILE.npz",
                   help="checkpoint the final state (core/checkpoint.py)")
    p.add_argument("--load-state", default=None, metavar="FILE.npz",
                   help="resume from a saved checkpoint")
    p.add_argument("--load-lenient", action="store_true",
                   help="accept a legacy checkpoint whose pytree structure "
                        "string cannot be validated (load_state "
                        "strict=False); leaf count/shape/dtype checks "
                        "still apply")
    p.add_argument("--interactive", action="store_true",
                   help="key-driven live mode (pause/step/reset plus "
                        "per-solver view cycles and parameter nudges); "
                        "supported by every solver subcommand")
    p.add_argument("--png", default=None, metavar="FILE.png",
                   help="export the final frame as a PNG (with --stride: "
                        "numbered FILE_0000.png per rendered frame)")


def _bench_report(name, steps, wall, cells=None):
    fps = steps / wall if wall > 0 else 0.0
    line = f"{name}: {steps} steps in {wall:.3f}s -> {fps:.1f} steps/s"
    if cells and wall > 0:
        mlups = cells * steps / wall / 1e6
        line += f", {mlups:.1f} MLUPS"
    print(line)


def _png_path(base: str, idx: int | None):
    if idx is None:
        return base
    stem, dot, ext = base.rpartition(".")
    return f"{stem}_{idx:04d}.{ext}" if dot else f"{base}_{idx:04d}"


def _maybe_png(args, rgb_fn, state, idx=None):
    if args is not None and getattr(args, "png", None) and rgb_fn is not None:
        from .io.png import write_png

        path = _png_path(args.png, idx)
        write_png(path, rgb_fn(state))
        if idx is None:
            print(f"wrote {path}")


def _run_headless(run_jit, state, steps, name, cells=None, chunk=50,
                  args=None, frame_fn=None, rgb_fn=None):
    """Drive `steps` physics steps.  With --render --stride N (and a
    frame_fn), renders a terminal frame every N steps — the live-animation
    loop of the reference's interactive apps; otherwise runs chunked
    benchmark mode and reports throughput.  `rgb_fn(state) -> (H, W, 3)
    uint8` feeds --png frame export (the raylib texture analog)."""
    import jax
    import numpy as np

    if args is not None and getattr(args, "load_state", None):
        from .core.checkpoint import load_state

        state = load_state(args.load_state, state,
                           strict=not getattr(args, "load_lenient", False))
        print(f"resumed from {args.load_state}")

    if args is not None and getattr(args, "png", None) and rgb_fn is None:
        print(f"WARNING: --png has no effect for {name} (no RGB export for "
              "this solver)", file=sys.stderr)

    if steps <= 0:
        _bench_report(name, 0, 0.0, cells)
        _maybe_png(args, rgb_fn, state)
        return _maybe_save(args, state)

    live = (args is not None and frame_fn is not None
            and (args.render or getattr(args, "png", None))
            and not args.headless and args.stride > 0)
    if live:
        out = state
        done = 0
        frame_i = 0
        t0 = time.perf_counter()
        first = True
        while done < steps:
            n = min(args.stride, steps - done)
            out = run_jit(out, n)
            done += n
            _maybe_png(args, rgb_fn, out, idx=frame_i)
            frame_i += 1
            if args.render:
                frame = frame_fn(out)
                if not first:
                    sys.stdout.write(f"\x1b[{frame.count(chr(10)) + 2}A")
                first = False
                print(frame)
                print(f"[{name}] step {done}/{steps}", flush=True)
        _ = np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
        _bench_report(name, done, time.perf_counter() - t0, cells)
        return _maybe_save(args, out)

    chunk = min(chunk, steps)  # avoid compiling an unused chunk size
    reps, rem = divmod(steps, chunk)
    warm = run_jit(state, chunk)
    if rem:
        warm = run_jit(warm, rem)
    jax.block_until_ready(warm)
    _ = np.asarray(jax.tree_util.tree_leaves(warm)[0]).ravel()[:1]

    t0 = time.perf_counter()
    out = state
    for _i in range(reps):
        out = run_jit(out, chunk)
    if rem:
        out = run_jit(out, rem)
    _ = np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
    wall = time.perf_counter() - t0
    _bench_report(name, reps * chunk + rem, wall, cells)
    _maybe_png(args, rgb_fn, out)
    return _maybe_save(args, out)


def _maybe_save(args, out):
    if args is not None and getattr(args, "save_state", None):
        from .core.checkpoint import save_state

        save_state(args.save_state, out)
        print(f"saved state to {args.save_state}")
    return out


def _maybe_render(args, text):
    if args.render and not args.headless:
        print(text)


def _report_overflow(n_dropped: int, n_total: int,
                     remedy="raise --bin-capacity or use --engine scatter "
                            "for exact physics"):
    """Surface cell-dense capacity overflow (ops/cell_dense.py): particles
    beyond a cell's K slots are dropped from interactions.  `remedy` names
    only flags the calling subcommand actually has (sph has no scatter
    engine, for instance)."""
    if n_dropped > 0:
        import sys

        print(
            f"WARNING: {n_dropped}/{n_total} particles exceed the cell-dense "
            f"bin capacity and are excluded from interactions this frame; "
            f"{remedy}",
            file=sys.stderr,
        )


def _norm01(a):
    import numpy as np

    a = np.asarray(a, np.float64)
    lo, hi = np.nanmin(a), np.nanmax(a)
    return np.nan_to_num((a - lo) / max(hi - lo, 1e-30))


def _basic_interactive(args, s0, make_runner, frame, reset_fn,
                       extra_keys=None, status_fn=None):
    """Wire the common pause / step-once / reset keys plus solver
    extras into core.interactive.interactive_loop (the reference's L4
    frame-loop controls; the q-only demos like tau_burgers.cu:752 get
    pause/reset on top)."""
    from .core.interactive import interactive_loop

    keys = {
        "p": ("pause", lambda ctx: setattr(ctx, "paused", not ctx.paused)),
        " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
        "r": ("reset", lambda ctx: setattr(ctx, "state", reset_fn())),
    }
    if extra_keys:
        keys.update(extra_keys)
    return interactive_loop(
        s0, make_runner, frame, keys, stride=max(args.stride, 1),
        max_steps=args.steps or None, status_fn=status_fn)


def _terminal_auto_size(nx, ny, render, halfblocks=False, fallback=128):
    """Size the grid to the terminal when --nx/--ny are 0, like the
    reference (tau_gray_scott.cu:283-296): width = columns, height =
    rows-1 (doubled for half-block rendering); headless falls back to
    a fixed size."""
    import shutil

    if nx and ny:
        return nx, ny
    cols, rows = shutil.get_terminal_size(fallback=(fallback, fallback))
    if not render:
        cols = rows = fallback
    else:
        rows = max(rows - 1, 1) * (2 if halfblocks else 1)
    return nx or cols, ny or rows


def cmd_gray_scott(args):
    import jax
    import numpy as np

    from .render.terminal import render_halfblocks, render_ramp
    from .solvers import gray_scott as gs

    nx, ny = _terminal_auto_size(args.nx, args.ny, args.render,
                                 args.halfblocks)
    cfg = gs.GrayScottConfig(
        nx=nx, ny=ny, dx=args.dx, dt=args.dt, Du=args.Du,
        Dv=args.Dv, feed=args.F, kill=args.k, seed=args.seed,
        dtype=args.dtype,
    )
    s = gs.init(cfg)
    run = jax.jit(lambda st, n: gs.run(cfg, st, n), static_argnums=1)

    def frame(st):
        v = np.asarray(st.v)
        return render_halfblocks(v) if args.halfblocks else render_ramp(v)

    from .render.colormap import jet

    if args.interactive:
        # live F/k nudges as traced scalars (no recompile) — explore the
        # Gray-Scott pattern space from the keyboard
        box = {"feed": cfg.feed, "kill": cfg.kill}
        irun = jax.jit(lambda st, n, F, k: gs.run(cfg, st, n, feed=F,
                                                  kill=k), static_argnums=1)

        def nudge(key, d):
            def h(ctx):
                box[key] = max(box[key] + d, 0.0)
            return h

        _basic_interactive(
            args, s, lambda: (lambda st, n: irun(st, n, box["feed"],
                                                 box["kill"])),
            frame, lambda: gs.init(cfg),
            extra_keys={
                "F": ("F+", nudge("feed", 0.001)),
                "f": ("F-", nudge("feed", -0.001)),
                "K": ("k+", nudge("kill", 0.0005)),
                "k": ("k-", nudge("kill", -0.0005)),
            },
            status_fn=lambda ctx: (f"F={box['feed']:.4f} "
                                   f"k={box['kill']:.4f}"))
        return

    out = _run_headless(run, s, args.steps, "gray-scott",
                        cells=cfg.nx * cfg.ny, args=args, frame_fn=frame,
                        rgb_fn=lambda st: jet(_norm01(st.v)))
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_burgers(args):
    import jax

    from .solvers import burgers as bg

    cfg = bg.BurgersConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dy=args.dy, nu=args.nu,
        u0=args.u0, amp=args.amp, bsig=args.bsig, swirl=args.swirl,
        rc=args.rc, offx=args.offx, offy=args.offy, asym=args.asym,
        cfl=args.CFL, tau0=args.tau0, t0=args.t0,
        dtau=args.dtau, muscl=args.muscl, visc_substeps=args.visc_substeps,
        colehopf=args.colehopf, ck=args.ck, ca=args.ca, dtype=args.dtype,
    )
    s = bg.init(cfg)
    run = jax.jit(lambda st, n: bg.run(cfg, st, n), static_argnums=1)

    def frame(st):
        import numpy as np

        from .render.terminal import render_ramp

        u, v = bg.velocities(cfg, st)
        speed = np.hypot(np.asarray(u), np.asarray(v))
        return render_ramp(speed, dither=True)

    def rgb(st):
        import numpy as np

        from .render.colormap import jet

        u, v = bg.velocities(cfg, st)
        return jet(_norm01(np.hypot(np.asarray(u), np.asarray(v))))

    if args.interactive:
        import numpy as np

        from .render.terminal import render_ramp

        box = {"view": "speed"}

        def iframe(st):
            u, v = bg.velocities(cfg, st)
            u, v = np.asarray(u), np.asarray(v)
            f = {"speed": np.hypot(u, v), "u": u, "v": v}[box["view"]]
            return render_ramp(f, dither=True)

        def status(ctx):
            ch = (f" colehopf_relL2={bg.cole_hopf_rel_l2(cfg, ctx.state):.2e}"
                  if cfg.colehopf else "")
            return (f"t={float(ctx.state.t):.4f} view={box['view']}{ch}")

        _basic_interactive(
            args, s, lambda: run, iframe, lambda: bg.init(cfg),
            extra_keys={"m": ("view", lambda ctx: box.update(
                view={"speed": "u", "u": "v", "v": "speed"}[box["view"]]))},
            status_fn=status)
        return

    out = _run_headless(run, s, args.steps, "burgers", cells=cfg.nx * cfg.ny,
                        args=args, frame_fn=frame, rgb_fn=rgb)
    if cfg.colehopf:
        print(f"cole-hopf rel L2 error: {bg.cole_hopf_rel_l2(cfg, out):.3e}")
    if args.render and not args.stride:
        _maybe_render(args, frame(out))


def cmd_shallow_water(args):
    import jax
    import numpy as np

    from .render.terminal import autocontrast, render_ramp
    from .solvers import shallow_water as sw

    cfg = sw.ShallowWaterConfig(
        nx=args.nx, ny=args.ny, dx=args.dx, dy=args.dy, g=args.g, f0=args.f0,
        nu=args.nu, H0=args.H0, bump_amp=args.amp, bump_sigma=args.bsig,
        offx=args.offx, offy=args.offy, asym=args.asym, swirl=args.swirl,
        swirl_rc=args.rc, tau0=args.tau0, t0=args.t0,
        dtau=args.dtau, dtype=args.dtype,
    )
    s = sw.init(cfg)
    run = jax.jit(lambda st, n: sw.run(cfg, st, n), static_argnums=1)

    def frame(st):
        return render_ramp(autocontrast(np.asarray(st.sigma)),
                           normalize=False)

    from .render.colormap import jet

    if args.interactive:
        box = {"view": "sigma"}

        def iframe(st):
            if box["view"] == "sigma":
                f = np.asarray(st.sigma)
            else:
                f = np.hypot(np.asarray(st.u), np.asarray(st.v))
            return render_ramp(autocontrast(f), normalize=False)

        _basic_interactive(
            args, s, lambda: run, iframe, lambda: sw.init(cfg),
            extra_keys={"m": ("view", lambda ctx: box.update(
                view="speed" if box["view"] == "sigma" else "sigma"))},
            status_fn=lambda ctx: (f"t={float(ctx.state.t):.4f} "
                                   f"view={box['view']}"))
        return

    out = _run_headless(
        run, s, args.steps, "shallow-water", cells=cfg.nx * cfg.ny,
        args=args, frame_fn=frame,
        rgb_fn=lambda st: jet(np.clip(autocontrast(np.asarray(st.sigma)),
                                      0, 1)))
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_lbm(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .solvers import lbm

    cfg = lbm.LBMConfig(
        nx=args.nx, ny=args.ny, tau=args.tau, drive=args.drive,
        obstacle=not args.no_obstacle, obstacle_radius=args.radius,
        dtype=args.dtype,
    )
    s = lbm.init(cfg)
    run = jax.jit(lambda st, n: lbm.run(cfg, st, n), static_argnums=1)

    def frame(st):
        sp = np.asarray(lbm.speed_field(cfg, st))
        return render_ramp(np.maximum(sp, 0.0))

    def rgb(st):
        from .render.colormap import jet

        return jet(_norm01(lbm.speed_field(cfg, st)))

    if args.interactive:
        # reference key set (tau_lbm.cu:281-286): +/- drive nudges,
        # o obstacle toggle (re-initializes the field like init_kernel)
        from dataclasses import replace as _rep

        from .core.interactive import interactive_loop

        box = {"cfg": cfg, "drive": cfg.drive}

        def make_runner():
            c = box["cfg"]
            irun = jax.jit(lambda st, n, d: lbm.run(c, st, n, drive=d),
                           static_argnums=1)
            return lambda st, n: irun(st, n, box["drive"])

        def drive(mult):
            # traced-scalar nudge: no recompile (cf. tau_lbm.cu's instant keys)
            def h(ctx):
                box["drive"] *= mult
            return h

        def toggle_obstacle(ctx):
            box["cfg"] = _rep(box["cfg"], obstacle=not box["cfg"].obstacle)
            ctx.state = lbm.init(box["cfg"])
            ctx.invalidate()

        def iframe(st):
            sp = np.asarray(lbm.speed_field(box["cfg"], st))
            return render_ramp(np.maximum(sp, 0.0))

        keys = {
            "+": ("drive+", drive(1.2)),
            "-": ("drive-", drive(1 / 1.2)),
            "o": ("obstacle", toggle_obstacle),
            " ": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
        }
        interactive_loop(
            s, make_runner, iframe, keys, stride=max(args.stride, 1),
            max_steps=args.steps or None,
            status_fn=lambda ctx: (
                f"drive={box['drive']:.2e} "
                f"obstacle={box['cfg'].obstacle}"))
        return

    out = _run_headless(run, s, args.steps, "lbm", cells=cfg.nx * cfg.ny,
                        args=args, frame_fn=frame, rgb_fn=rgb)
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_hypersonic2d(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .render.views import VIEW_MODES, normalize_masked, render_value
    from .solvers import hypersonic2d as h2

    cfg = h2.default_config(
        nx=args.nx, ny=args.ny, gamma=args.gamma, cfl=args.cfl,
        visc_nu=args.visc_nu, visc_rho=args.visc_rho, visc_e=args.visc_e,
        inflow_mach=args.mach, dtype=args.dtype,
    )
    s = h2.init(cfg)
    run = jax.jit(lambda st, n: h2.run(cfg, st, n), static_argnums=1)

    if args.serve:
        # Live browser stream of the 2-D field (VERDICT r4 missing #3 —
        # the reference renders every 2-D solver in a live window,
        # tau_hypersonic_cuda.cu:1892-1933): the view field is
        # mean-pooled to <= --serve-max per axis, gamma-quantized on
        # device and streamed as a depth-1 .4spl volume the web viewer's
        # ?live=1 mode follows.
        import jax.numpy as jnp

        from .io import fourspl
        from .io.live4spl import Stream4splWriter
        from .solvers.th3cs import stream_frames

        fy = max(1, -(-cfg.ny // args.serve_max))
        fx = max(1, -(-cfg.nx // args.serve_max))
        Hc, Wc = cfg.ny // fy, cfg.nx // fx

        @jax.jit
        def frame_fn(st):
            st2 = run(st, args.steps_per_frame)
            v = render_value(cfg, st2, args.view)
            t = normalize_masked(v, st2.mask)
            t = jnp.where(st2.mask, 0.0, jnp.clip(t, 0.0, 1.0))
            t = t[: Hc * fy, : Wc * fx].reshape(Hc, fy, Wc, fx).mean((1, 3))
            # flip y so the viewer's z-up volume shows the domain upright
            return st2, fourspl.quantize_frame_device(t[::-1][None],
                                                      gamma=0.65)

        def produce(stream_path):
            with Stream4splWriter(stream_path, Wc, Hc, 1,
                                  fourspl.heat_palette(256)) as wtr:
                stream_frames(frame_fn, s, args.frames, wtr, verbose=True)

        _live_serve(args.out, args.port, produce)
        return

    def frame(st):
        assert args.view in VIEW_MODES, f"--view must be one of {VIEW_MODES}"
        v = render_value(cfg, st, args.view)
        t = np.asarray(normalize_masked(v, st.mask))
        if args.colors == "256":
            from .render.terminal import render_palette256

            bands = np.clip((t * 255 + 0.5).astype(int), 0, 255)
            return render_palette256(bands)
        return render_ramp(t, normalize=False)

    if args.interactive:
        # reference key set: R reset, M view cycle, SPACE pause
        # (tau_hypersonic_cuda.cu:1825-1831; SPACE is a toggle here)
        from .core.interactive import interactive_loop

        view = {"mode": args.view}

        def iframe(st):
            v = render_value(cfg, st, view["mode"])
            return render_ramp(np.asarray(normalize_masked(v, st.mask)),
                               normalize=False)

        def cycle_view(ctx):
            i = VIEW_MODES.index(view["mode"])
            view["mode"] = VIEW_MODES[(i + 1) % len(VIEW_MODES)]

        keys = {
            "r": ("reset", lambda ctx: setattr(ctx, "state", h2.init(cfg))),
            "m": ("view", cycle_view),
            " ": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
        }
        interactive_loop(
            s, lambda: run, iframe, keys, stride=max(args.stride, 1),
            max_steps=args.steps or None,
            status_fn=lambda ctx: f"view={view['mode']} "
                                  f"t={float(ctx.state.t):.5f}")
        return

    def rgb(st):
        from .render.colormap import jet

        v = render_value(cfg, st, args.view)
        t = np.asarray(normalize_masked(v, st.mask))
        img = jet(np.clip(t, 0, 1))
        img[np.asarray(st.mask)] = 0
        return img

    out = _run_headless(run, s, args.steps, "hypersonic2d",
                        cells=cfg.nx * cfg.ny, args=args, frame_fn=frame,
                        rgb_fn=rgb)
    print(f"t = {float(out.t):.6f}")
    if args.render and not args.stride:
        _maybe_render(args, frame(out))


def cmd_hypersonic3d(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .solvers import hypersonic3d as h3

    cfg = h3.default_config(args.n, dtype=args.dtype, outflow=args.outflow)
    s = h3.init(cfg)
    run = jax.jit(lambda st, n: h3.run(cfg, st, n), static_argnums=1)

    box = {"view": args.view, "log": False, "zslice": cfg.nz // 2,
           "a_gain": 1.0}

    def frame(st):
        vol = np.asarray(h3.vis_field(cfg, st, box["view"]))
        if box["log"]:
            vol = np.log1p(np.abs(vol))
        return render_ramp(vol[box["zslice"]])

    if args.interactive:
        # reference key set (tau_hypersonic_3d_cuda.cu:1645-1672): SPACE
        # pause, M view cycle, L log scale, R reset, -/= inflow gain
        # nudge (a runtime scan argument — no recompile), [/] z-slice
        gain_run = jax.jit(
            lambda st, n, g: h3.run(cfg, st, n, gain_mul=g),
            static_argnums=1)

        def make_runner():
            return lambda st, n: gain_run(st, n, box["a_gain"])

        def cycle_view(ctx):
            modes = h3.VIS_MODES
            box["view"] = modes[(modes.index(box["view"]) + 1) % len(modes)]

        def gain(f, lo, hi):
            def h(ctx):
                box["a_gain"] = min(max(box["a_gain"] * f, lo), hi)
            return h

        _basic_interactive(
            args, s, make_runner, frame, lambda: h3.init(cfg),
            extra_keys={
                "m": ("view", cycle_view),
                "l": ("log", lambda ctx: box.update(log=not box["log"])),
                "-": ("gain-", gain(0.85, 0.05, 2.0)),
                "=": ("gain+", gain(1.18, 0.05, 2.0)),
                "[": ("slice-", lambda ctx: box.update(
                    zslice=(box["zslice"] - 1) % cfg.nz)),
                "]": ("slice+", lambda ctx: box.update(
                    zslice=(box["zslice"] + 1) % cfg.nz)),
            },
            status_fn=lambda ctx: (
                f"t={float(ctx.state.t):.4f} view={box['view']}"
                f"{' log' if box['log'] else ''} z={box['zslice']} "
                f"a_gain={box['a_gain']:.2f}"))
        return

    out = _run_headless(run, s, args.steps, "hypersonic3d",
                        cells=cfg.nx * cfg.ny * cfg.nz, args=args,
                        frame_fn=frame)
    refl = float(h3.outflow_reflection_metric(cfg, out))
    print(f"t = {float(out.t):.6f} dtau = {float(out.dtau):.3e} "
          f"refl_dp = {refl:.3e}")
    if args.render and not args.stride:
        _maybe_render(args, frame(out))


def _live_serve(out_path, port, produce):
    """Shared --serve scaffolding: serve a temp dir holding the web viewer
    plus a growing volume.4spl, run `produce(stream_path)` (the streaming
    export), copy the result to `out_path`, then keep serving the replay
    until Ctrl-C/SIGTERM.  The reference's live window
    (tau_hypersonic_cuda.cu:1892-1933, tau_hypersonic_3d_cuda.cu:1416-1497)
    re-homed to a browser polling the stream."""
    import pathlib
    import shutil
    import signal
    import tempfile
    import time

    from .io.live4spl import serve_dir

    # a supervisor's SIGTERM must exit the serve loop as cleanly as Ctrl-C
    # (flush/copy the stream, shut the server down) — same discipline as
    # the interactive raw-mode traps (core/interactive.py)
    def _term(signum, frame):
        raise KeyboardInterrupt

    prev_term = signal.signal(signal.SIGTERM, _term)
    viewer = (pathlib.Path(__file__).resolve().parent.parent
              / "viewer" / "index.html")
    with tempfile.TemporaryDirectory(prefix="fst_live_") as tmp:
        shutil.copy(viewer, pathlib.Path(tmp) / "index.html")
        stream_path = pathlib.Path(tmp) / "volume.4spl"
        srv, _ = serve_dir(tmp, port)
        bound = srv.server_address[1]
        print(f"live viewer: http://127.0.0.1:{bound}/index.html?live=1",
              flush=True)
        try:
            produce(stream_path)
            shutil.copy(stream_path, out_path)
            print(f"wrote {out_path}; still serving the replay "
                  "(Ctrl-C to stop)", flush=True)
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            # mid-stream interrupt: persist whatever frames completed so
            # --out is never empty when the caller asked for an export
            if not pathlib.Path(out_path).exists() and stream_path.exists():
                shutil.copy(stream_path, out_path)
                print(f"interrupted; wrote partial {out_path}", flush=True)
        finally:
            srv.shutdown()
            signal.signal(signal.SIGTERM, prev_term)


def cmd_th3cs(args):
    from .solvers import hypersonic3d as h3
    from .solvers.th3cs import export_4spl, export_4spl_streamed

    cfg = h3.default_config(args.n)
    if not args.serve:
        export_4spl(args.out, cfg, frames=args.frames,
                    steps_per_frame=args.steps_per_frame, verbose=True)
        print(f"wrote {args.out}")
        return

    _live_serve(args.out, args.port,
                lambda sp: export_4spl_streamed(
                    sp, cfg, frames=args.frames,
                    steps_per_frame=args.steps_per_frame, verbose=True))


def cmd_mhd(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .solvers import mhd

    cfg = mhd.MHDConfig(nx=args.nx, ny=args.ny, problem=args.case,
                        stable_hll=args.stable_hll, dtype=args.dtype)
    s = mhd.init(cfg)
    run = jax.jit(lambda st, n: mhd.run(cfg, st, n), static_argnums=1)

    def frame(st):
        return render_ramp(np.asarray(mhd.view_field(cfg, st, args.view)))

    from .render.colormap import mhd_cmap

    if args.interactive:
        # reference key set (tau_mhd.c:190-193): SPACE pause, R reset,
        # M view cycle, C problem cycle (re-inits)
        view_names = ["rho", "p", "|B|", "|divB|"]
        problems = ["briowu", "orszag-tang"]
        box = {"view": int(args.view), "cfg": cfg}

        def iframe(st):
            return render_ramp(np.asarray(
                mhd.view_field(box["cfg"], st, box["view"])))

        def cycle_problem(ctx):
            prob = problems[(problems.index(box["cfg"].problem) + 1)
                            % len(problems)]
            from dataclasses import replace as _rep

            box["cfg"] = _rep(box["cfg"], problem=prob)
            ctx.state = mhd.init(box["cfg"])
            ctx.invalidate()

        def make_runner():
            import jax as _jax

            c = box["cfg"]
            return _jax.jit(lambda st, n: mhd.run(c, st, n),
                            static_argnums=1)

        _basic_interactive(
            args, s, make_runner, iframe,
            lambda: mhd.init(box["cfg"]),
            extra_keys={
                "m": ("view", lambda ctx: box.update(
                    view=(box["view"] + 1) % 4)),
                "c": ("problem", cycle_problem),
            },
            status_fn=lambda ctx: (f"t={float(ctx.state.t):.4f} "
                                   f"view={view_names[box['view']]} "
                                   f"problem={box['cfg'].problem}"))
        return

    out = _run_headless(
        run, s, args.steps, "mhd", cells=cfg.nx * cfg.ny, args=args,
        frame_fn=frame,
        rgb_fn=lambda st: mhd_cmap(
            _norm01(mhd.view_field(cfg, st, args.view))))
    print(f"t = {float(out.t):.6f}")
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_stam2d(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .solvers import stam2d

    cfg = stam2d.Stam2DConfig(n=args.n, dtype=args.dtype)
    s = stam2d.init(cfg)
    run = jax.jit(lambda st, n: stam2d.run(cfg, st, n), static_argnums=1)

    def frame(st):
        return render_ramp(np.clip(np.asarray(st.d), 0, 1), normalize=False)

    from .render.colormap import jet

    if args.interactive:
        _basic_interactive(
            args, s, lambda: run, frame, lambda: stam2d.init(cfg))
        return

    out = _run_headless(run, s, args.steps, "stam2d", cells=cfg.n * cfg.n,
                        args=args, frame_fn=frame,
                        rgb_fn=lambda st: jet(
                            np.clip(np.asarray(st.d), 0, 1)))
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_stam3d(args):
    import jax
    import numpy as np

    from .solvers import stam3d

    cfg = stam3d.Stam3DConfig(n=args.n, dt=args.dt, visc=args.visc,
                              diff=args.diff, decay=args.decay,
                              src_gain=args.src_gain, src_freq=args.src_freq,
                              seed_amp=args.amp, seed_noise=args.noise,
                              seed_dens_amp=args.dens_amp,
                              seed_sigma=args.sigma,
                              jacobi_iters=args.jacobi, seed=args.seed,
                              dtype=args.dtype,
                              advect_k=args.advect_k)
    s = stam3d.init(cfg)
    run = jax.jit(lambda st, n: stam3d.run(cfg, st, n), static_argnums=1)

    def frame(st):
        img = np.asarray(stam3d.iso_render(cfg, st, W=args.cols,
                                           H=args.rows, gain=args.gain,
                                           gamma=args.gamma,
                                           levels=args.levels))
        if args.colors == "256":
            from .render.terminal import render_palette256

            return render_palette256(img)
        from .render.terminal import RAMP_BLOCKS

        t = img / max(img.max(), 1)
        idx = np.clip((t * 4 + 0.5).astype(int), 0, 4)
        return "\n".join("".join(RAMP_BLOCKS[k] for k in row) for row in idx)

    if args.interactive:
        _basic_interactive(
            args, s, lambda: run, frame, lambda: stam3d.init(cfg),
            status_fn=lambda ctx: f"advect_k={cfg.advect_k}")
        return

    out = _run_headless(run, s, args.steps, "stam3d", cells=cfg.n**3,
                        args=args, frame_fn=frame)
    if cfg.advect_k >= 1:
        capped = int(stam3d.advect_capped_count(cfg, out))
        if capped:
            import sys

            print(f"WARNING: {capped} cells exceeded the advect_k="
                  f"{cfg.advect_k} backtrace cap on the final frame; raise "
                  "--advect-k (or --advect-k 0 for the exact gather path)",
                  file=sys.stderr)
    if args.render and not args.stride:
        print(frame(out))


def cmd_sph(args):
    import jax
    import numpy as np

    from .solvers import sph

    cfg = sph.SPHConfig(n=args.n, box_x=args.box, box_y=args.box,
                        rho0=args.rho0, c0=args.c0, gamma_eos=args.gamma,
                        gravity=args.gravity, dtau=args.dTau, cfl=args.CFL,
                        visc_alpha=args.visc, visc_substeps=args.visc_substeps,
                        use_xsph=args.xsph, xsph_eps=args.xsph_eps,
                        seed=args.seed,
                        rain=not args.no_rain, engine=args.engine,
                        cell_capacity=args.bin_capacity, dtype=args.dtype)
    s = sph.init(cfg)
    run = jax.jit(lambda st, n: sph.run(cfg, st, n), static_argnums=1)

    def frame(st):
        grid = np.asarray(sph.rasterize_counts(cfg, st.pos, W=args.cols,
                                               H=args.rows))
        top = grid[0::2][:args.rows]
        bot = grid[1::2][:args.rows]
        chars = np.where((top > 0) & (bot > 0), "█",
                         np.where(top > 0, "▀",
                                  np.where(bot > 0, "▄", " ")))
        return "\n".join("".join(r) for r in chars)

    if args.interactive:
        # reference key set (tau_sph.cu:622-657): p pause, SPACE step-once,
        # r reset, g gravity, v viscosity, =/- smoothing length, ]/[ c0,
        # >/< dTau.  h/c0/grav/visc nudges rebuild the jitted runner (the
        # analog of ensure_cell_buffers re-deriving the cell grid); dTau
        # only enters the clock math, so it rides as a traced scalar with
        # no recompile (the reference's instant keys).
        from dataclasses import replace as _rep

        from .core.interactive import interactive_loop

        box = {"cfg": cfg, "dtau": cfg.dtau}

        def nudge(**field_factors):
            def h(ctx):
                c = box["cfg"]
                box["cfg"] = _rep(c, **{f: getattr(c, f) * m if m else
                                        not getattr(c, f)
                                        for f, m in field_factors.items()})
                ctx.invalidate()
            return h

        def nudge_dtau(mult):
            def h(ctx):
                box["dtau"] *= mult
            return h

        def make_runner():
            c = box["cfg"]
            irun = jax.jit(lambda st, n, d: sph.run(c, st, n, dtau=d),
                           static_argnums=1)
            return lambda st, n: irun(st, n, box["dtau"])

        keys = {
            "p": ("pause", lambda ctx: setattr(ctx, "paused",
                                               not ctx.paused)),
            " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
            "r": ("reset", lambda ctx: setattr(ctx, "state",
                                               sph.init(box["cfg"]))),
            "g": ("grav", nudge(use_grav=None)),
            "v": ("visc", nudge(use_visc=None)),
            "=": ("h+", nudge(h_mul=1.05)),
            "-": ("h-", nudge(h_mul=0.95)),
            "]": ("c0+", nudge(c0=1.05)),
            "[": ("c0-", nudge(c0=0.95)),
            ">": ("dTau+", nudge_dtau(1.2)),
            "<": ("dTau-", nudge_dtau(1 / 1.2)),
        }
        interactive_loop(
            s, make_runner, frame, keys, stride=max(args.stride, 1),
            max_steps=args.steps or None,
            status_fn=lambda ctx: (
                f"t={float(ctx.state.t):.3f} h={box['cfg'].h:.4f} "
                f"c0={box['cfg'].c0:.2f} dTau={box['dtau']:.3f} "
                f"grav={box['cfg'].use_grav} visc={box['cfg'].use_visc}"))
        return

    out = _run_headless(run, s, args.steps, "sph", args=args, frame_fn=frame)
    print(f"t = {float(out.t):.4f} tau = {float(out.tau):.4f}  "
          f"({cfg.n * args.steps / 1e6:.2f}M particle-steps)")
    _report_overflow(int(sph.overflow_count(cfg, out)), cfg.n,
                     remedy="raise --bin-capacity or use --engine exact")
    if args.render and not args.stride:
        print(frame(out))


def cmd_flip(args):
    import jax
    import numpy as np

    from .render.terminal import render_ramp
    from .solvers import flip_apic as fa

    cfg = fa.FlipApicConfig(particles=args.particles, grid=args.grid,
                            jacobi=args.jacobi, dt=args.dt,
                            gravity=args.gravity, flip=args.flip,
                            apic=args.apic, engine=args.engine,
                            bin_capacity=args.bin_capacity,
                            dtype=args.dtype)
    s = fa.init(cfg)
    run = jax.jit(lambda st, n: fa.run(cfg, st, n), static_argnums=1)

    def frame(st):
        return render_ramp(np.asarray(st.density)[::-1].astype(float))

    if args.interactive:
        # flip/apic blend nudges ride as traced scalars: no recompile
        box = {"cfg": cfg, "flip": cfg.flip, "apic": cfg.apic}

        def make_runner():
            c = box["cfg"]
            irun = jax.jit(
                lambda st, n, f, a: fa.run(c, st, n, flip=f, apic=a),
                static_argnums=1)
            return lambda st, n: irun(st, n, box["flip"], box["apic"])

        def blend(field, d):
            def h(ctx):
                box[field] = min(max(box[field] + d, 0.0), 1.0)
            return h

        _basic_interactive(
            args, s, make_runner, frame,
            lambda: fa.init(box["cfg"]),
            extra_keys={
                "f": ("flip-", blend("flip", -0.05)),
                "F": ("flip+", blend("flip", 0.05)),
                "a": ("apic-", blend("apic", -0.05)),
                "A": ("apic+", blend("apic", 0.05)),
            },
            status_fn=lambda ctx: (f"flip={box['flip']:.2f} "
                                   f"apic={box['apic']:.2f}"))
        return

    out = _run_headless(run, s, args.steps, "flip-apic", args=args,
                        frame_fn=frame)
    dens = np.asarray(out.density)
    occupied = int((dens > 0).sum())
    print(f"occupied={occupied} peak_cell={int(dens.max())}")
    _report_overflow(int(fa.overflow_count(cfg, out)), cfg.particles)
    if not args.stride:
        _maybe_render(args, frame(out))


def cmd_mpm(args):
    import jax
    import numpy as np

    from .solvers import mpm

    cfg = mpm.MPMConfig(n=args.n, gx=args.gx, gy=args.gy, dt=args.dt,
                        gravity=args.gravity, seed=args.seed,
                        material=args.material, engine=args.engine,
                        bin_capacity=args.bin_capacity,
                        dtype=args.dtype)
    s = mpm.init(cfg)
    run = jax.jit(lambda st, n: mpm.run(cfg, st, n), static_argnums=1)

    def frame(st):
        pos = np.asarray(st.pos)
        Wd, Hd = args.cols, args.rows
        cx = np.clip((pos[:, 0] / cfg.box_x * (Wd - 1)).astype(int), 0, Wd - 1)
        sy = np.clip(((cfg.box_y - pos[:, 1]) / cfg.box_y
                      * (2 * Hd - 1)).astype(int), 0, 2 * Hd - 1)
        grid = np.zeros((2 * Hd, Wd), int)
        np.add.at(grid, (sy, cx), 1)
        top, bot = grid[0::2], grid[1::2]
        chars = np.where((top > 0) & (bot > 0), "█",
                         np.where(top > 0, "▀",
                                  np.where(bot > 0, "▄", " ")))
        return "\n".join("".join(r) for r in chars)

    if args.interactive:
        # material cycling + reset (the tau_mpm.cu material set as live
        # keys; cycling re-inits like the reference's per-material runs)
        from dataclasses import replace as _rep

        mats = ["mud", "snow", "sand"]
        box = {"cfg": cfg}

        def make_runner():
            c = box["cfg"]
            return jax.jit(lambda st, n: mpm.run(c, st, n),
                           static_argnums=1)

        def cycle_mat(ctx):
            c = box["cfg"]
            box["cfg"] = _rep(c, material=mats[
                (mats.index(c.material) + 1) % len(mats)])
            ctx.state = mpm.init(box["cfg"])
            ctx.invalidate()

        _basic_interactive(
            args, s, make_runner, frame,
            lambda: mpm.init(box["cfg"]),
            extra_keys={"m": ("material", cycle_mat)},
            status_fn=lambda ctx: f"material={box['cfg'].material}")
        return

    out = _run_headless(run, s, args.steps, "mpm", args=args, frame_fn=frame)
    _report_overflow(int(mpm.overflow_count(cfg, out)), cfg.n)
    if args.render and not args.stride:
        print(frame(out))


def cmd_hypersonic2d_cpu(args):
    import time as _time

    import numpy as np

    from .solvers.hypersonic2d_cpu import HypersonicCPU, HypersonicCPUConfig

    cfg = HypersonicCPUConfig(w=args.nx, h=args.ny, gamma=args.gamma,
                              cfl=args.cfl, mach=args.mach)
    if getattr(args, "interactive", False):
        import sys

        print("WARNING: --interactive has no effect for hypersonic2d-cpu "
              "(batch oracle solver; use hypersonic2d for the live view)",
              file=sys.stderr)
    if args.native:
        from .solvers.hypersonic2d_cpu_native import HypersonicCPUNative

        with HypersonicCPUNative(cfg) as sim:
            t0 = _time.perf_counter()
            sim.step(args.steps)
            wall = _time.perf_counter() - t0
            U, mask, t = sim.state
    else:
        sim = HypersonicCPU(cfg)
        t0 = _time.perf_counter()
        for _ in range(args.steps):
            sim.step()
        wall = _time.perf_counter() - t0
        U, mask, t = sim.U, sim.mask, sim.t
    rho = np.maximum(U[..., 0], 1e-10)
    print(f"hypersonic2d-cpu[{'native' if args.native else 'numpy'}]: "
          f"{args.steps} steps in {wall:.3f}s -> "
          f"{args.steps / wall:.1f} steps/s")
    print(f"t = {t:.6f}  rho range [{rho[~mask].min():.4f}, "
          f"{rho[~mask].max():.4f}]")


def _nbody_live(args, cfg):
    """Live terminal view of the relaxing layout with the reference's
    camera keys — pause, refit, reset, color cycle, +/- frame stride,
    pan/zoom in 2-D (number_fluid2d.c:805-888), orbit yaw/pitch/zoom in
    3-D (number_fluid3d.c:909-958)."""
    import numpy as np

    from .core.interactive import interactive_loop
    from .render import points as rp
    from .solvers import nbody_graph as ng

    schemes = list(rp.SCHEMES)
    box = {"scheme": args.scheme, "cam": None}
    three_d = cfg.dims == 3

    if args.native:
        from .solvers import nbody_native as nn

        p0, v0, edges = ng.init_arrays(cfg)
        eng = nn.BHEngine(cfg, edges, n_threads=args.threads or None,
                          theta=args.theta)
        eng.__enter__()
        eng.set_state(p0, v0)

        def make_runner():
            def run(state, n):
                eng.run(n)
                return eng.get_state()[0]

            return run

        state0 = p0
        n_edges = len(edges)

        def reset(ctx):
            eng.set_state(p0, v0)
            ctx.state = p0
            box["cam"] = None
    else:
        import jax

        s0 = ng.init(cfg)
        jrun = jax.jit(lambda st, n: ng.run(cfg, st, n), static_argnums=1)

        def make_runner():
            return jrun

        state0 = s0
        n_edges = int(s0.edges.shape[0])

        def reset(ctx):
            ctx.state = s0
            box["cam"] = None

    def pos_of(state):
        return np.asarray(state if args.native else state.pos)

    def frame(state):
        pos = pos_of(state)
        if box["cam"] is None:
            box["cam"] = (rp.fit_orbit(pos) if three_d
                          else rp.camera_fit(pos, args.cols, args.rows))
        if three_d:
            return rp.render_points_3d(pos, args.cols, args.rows,
                                       scheme=box["scheme"],
                                       color=not args.no_color,
                                       camera=box["cam"])
        return rp.render_points(pos, args.cols, args.rows,
                                scheme=box["scheme"],
                                color=not args.no_color, camera=box["cam"])

    def pan(dx, dy):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.Camera2D):
                cam.tx += dx * args.cols * 0.15 / cam.zoom
                cam.ty += dy * args.rows * 0.3 / cam.zoom
        return h

    def zoom(f):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.Camera2D):
                cam.zoom = min(max(cam.zoom * f, 1e-9), 1e9)
            elif isinstance(cam, rp.OrbitCamera):
                cam.distance = max(cam.distance / f, 1e-6)
        return h

    def orbit(dyaw, dpitch):
        def h(ctx):
            cam = box["cam"]
            if isinstance(cam, rp.OrbitCamera):
                cam.yaw += dyaw
                cam.pitch = min(max(cam.pitch + dpitch, -1.55), 1.55)
        return h

    def stride_mul(f):
        def h(ctx):
            ctx.stride = min(max(int(ctx.stride * f), 1), 64)
        return h

    keys = {
        "p": ("pause", lambda ctx: setattr(ctx, "paused", not ctx.paused)),
        " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
        "r": ("refit", lambda ctx: box.update(cam=None)),
        "b": ("reset", reset),
        "c": ("colors", lambda ctx: box.update(
            scheme=schemes[(schemes.index(box["scheme"]) + 1)
                           % len(schemes)])),
        "z": ("zoom+", zoom(1.12)),
        "x": ("zoom-", zoom(1 / 1.12)),
        "+": ("stride*2", stride_mul(2)),
        "-": ("stride/2", stride_mul(0.5)),
    }
    if three_d:
        keys.update({
            "a": ("yaw-", orbit(-0.1, 0)),
            "d": ("yaw+", orbit(0.1, 0)),
            "w": ("pitch+", orbit(0, 0.1)),
            "s": ("pitch-", orbit(0, -0.1)),
        })
    else:
        keys.update({
            "h": ("pan-l", pan(-1, 0)),
            "l": ("pan-r", pan(1, 0)),
            "j": ("pan-d", pan(0, -1)),
            "k": ("pan-u", pan(0, 1)),
        })

    def status(ctx):
        cam = box["cam"]
        view = (f"yaw={cam.yaw:.2f} pitch={cam.pitch:.2f} "
                f"dist={cam.distance:.0f}" if isinstance(cam, rp.OrbitCamera)
                else f"zoom={cam.zoom:.3g}" if cam else "")
        return (f"{cfg.n_bodies} nodes {n_edges} edges "
                f"stride={ctx.stride} [{box['scheme']}] {view}")

    try:
        interactive_loop(
            state0, make_runner, frame, keys,
            stride=max(args.stride, 1), max_steps=args.steps or None,
            status_fn=status)
    finally:
        if args.native:
            eng.__exit__(None, None, None)


def cmd_nbody(args):
    import time as _time

    import numpy as np

    from .solvers import nbody_graph as ng

    cfg = ng.GraphLayoutConfig(max_number=args.max_number, dims=args.dims,
                               grid_res=args.grid_res, engine=args.engine,
                               dtype=args.dtype)
    # --interactive runs until 'q' (and implies --render: the reference
    # graph demos are interactive VISUAL programs); --render --stride
    # alone animates but must stay bounded (a scripted `--stride N
    # --steps 0` run would otherwise wait forever for a keypress)
    if args.interactive or (args.render and args.stride and args.steps):
        _nbody_live(args, cfg)
        return
    if args.native:
        # pure host path: never touches jax / the device
        from .solvers import nbody_native as nn

        p0, v0, edges = ng.init_arrays(cfg)
        with nn.BHEngine(cfg, edges, n_threads=args.threads or None,
                         theta=args.theta) as eng:
            eng.set_state(p0, v0)
            t0 = _time.perf_counter()
            eng.run(args.steps)
            wall = _time.perf_counter() - t0
            pos, _ = eng.get_state()
        n_edges = len(edges)
    else:
        import jax

        s = ng.init(cfg)
        run = jax.jit(lambda st, n: ng.run(cfg, st, n), static_argnums=1)
        t0 = _time.perf_counter()
        out = run(s, args.steps)
        _ = np.asarray(out.pos[0, 0])
        wall = _time.perf_counter() - t0
        pos = np.asarray(out.pos)
        n_edges = out.edges.shape[0]
    print(f"nbody: {args.steps} steps, {cfg.n_bodies} nodes, "
          f"{n_edges} edges -> {args.steps / wall:.1f} steps/s")
    print(f"layout extent: {np.abs(pos).max():.1f}")
    if args.render:
        from .render.points import render_points, render_points_3d

        if cfg.dims == 3:
            print(render_points_3d(pos, W=args.cols, H=args.rows,
                                   scheme=args.scheme,
                                   color=not args.no_color))
        else:
            print(render_points(pos, W=args.cols, H=args.rows,
                                scheme=args.scheme,
                                color=not args.no_color))


def cmd_regression(args):
    import sys as _sys

    from .regression import run_regression

    code = run_regression(nx=args.nx, ny=args.ny, steps=args.steps,
                          baseline=args.baseline, write=args.write_baseline)
    _sys.exit(code)


def build_parser():
    ap = argparse.ArgumentParser(prog="fluidsims_tpu",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gray-scott", help="reaction-diffusion (tau_gray_scott)")
    p.add_argument("--nx", type=int, default=0,
                   help="0 = terminal width when rendering, else 128")
    p.add_argument("--ny", type=int, default=0,
                   help="0 = terminal height when rendering, else 128")
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--Du", type=float, default=0.2)
    p.add_argument("--Dv", type=float, default=0.1)
    p.add_argument("--F", type=float, default=0.03)
    p.add_argument("--k", type=float, default=0.06)
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--halfblocks", action="store_true")
    _common(p, 2000)
    p.set_defaults(fn=cmd_gray_scott)

    p = sub.add_parser("burgers", help="2-D viscous Burgers (tau_burgers)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=512)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=0.1)
    p.add_argument("--u0", type=float, default=1.0)
    # initial-condition shaping (tau_burgers.cu getopt: amp/bsig/swirl/rc/
    # offx/offy/asym)
    p.add_argument("--amp", type=float, default=1.0)
    p.add_argument("--bsig", type=float, default=16.0)
    p.add_argument("--swirl", type=float, default=10.0)
    p.add_argument("--rc", type=float, default=40.0)
    p.add_argument("--offx", type=float, default=0.0)
    p.add_argument("--offy", type=float, default=0.0)
    p.add_argument("--asym", type=float, default=0.0)
    p.add_argument("--CFL", type=float, default=0.45)
    p.add_argument("--tau0", type=float, default=0.0)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--dtau", type=float, default=1.0)
    p.add_argument("--muscl", action="store_true")
    p.add_argument("--visc_substeps", type=int, default=1)
    p.add_argument("--colehopf", action="store_true")
    p.add_argument("--ck", type=int, default=4)
    p.add_argument("--ca", type=float, default=0.5)
    _common(p, 2000)
    p.set_defaults(fn=cmd_burgers)

    p = sub.add_parser("shallow-water", help="shallow water (tau_shallow_water)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=512)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    p.add_argument("--g", type=float, default=9.81)
    p.add_argument("--f0", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=0.001)
    p.add_argument("--H0", type=float, default=1000.0)
    # initial-condition shaping (tau_shallow_water.cu getopt: amp/bsig/
    # offx/offy/asym/swirl/rc)
    p.add_argument("--amp", type=float, default=1.0)
    p.add_argument("--bsig", type=float, default=1.0)
    p.add_argument("--offx", type=float, default=100.0)
    p.add_argument("--offy", type=float, default=100.0)
    p.add_argument("--asym", type=float, default=10.0)
    p.add_argument("--swirl", type=float, default=1.0)
    p.add_argument("--rc", type=float, default=100.0)
    p.add_argument("--tau0", type=float, default=0.0)
    p.add_argument("--t0", type=float, default=1.0)
    p.add_argument("--dtau", type=float, default=1.0)
    _common(p, 2000)
    p.set_defaults(fn=cmd_shallow_water)

    p = sub.add_parser("lbm", help="D2Q9 lattice Boltzmann (tau_lbm)")
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ny", type=int, default=256)
    p.add_argument("--tau", type=float, default=0.56)
    p.add_argument("--drive", type=float, default=1e-6)
    p.add_argument("--radius", type=float, default=32.0)
    p.add_argument("--no-obstacle", action="store_true")
    _common(p, 1000)
    p.set_defaults(fn=cmd_lbm)

    p = sub.add_parser("hypersonic2d",
                       help="2-D hypersonic flow (tau_hypersonic_cuda)")
    p.add_argument("--nx", type=int, default=2048)
    p.add_argument("--ny", type=int, default=1024)
    p.add_argument("--gamma", type=float, default=1.1)
    p.add_argument("--cfl", type=float, default=0.25)
    p.add_argument("--visc-nu", type=float, default=5e-2)
    p.add_argument("--visc-rho", type=float, default=5e-2)
    p.add_argument("--visc-e", type=float, default=2e-2)
    p.add_argument("--mach", type=float, default=25.0)
    p.add_argument("--view", default="schlieren")
    p.add_argument("--colors", choices=("mono", "256"), default="mono",
                   help="256 = dynamic-palette ANSI renderer "
                        "(js_cuda3d.cu:471-517)")
    p.add_argument("--serve", action="store_true",
                   help="stream the view field live to the web viewer "
                        "while the solver runs (prints the URL)")
    p.add_argument("--frames", type=int, default=120,
                   help="--serve frame count")
    p.add_argument("--steps-per-frame", type=int, default=4,
                   help="--serve physics steps per streamed frame")
    p.add_argument("--serve-max", type=int, default=256,
                   help="--serve raster cap per axis (mean-pooled)")
    p.add_argument("--port", type=int, default=0,
                   help="--serve HTTP port (0 = pick a free one)")
    p.add_argument("--out", default="hypersonic2d.4spl",
                   help="--serve stream export path")
    _common(p, 100)
    p.set_defaults(fn=cmd_hypersonic2d)

    p = sub.add_parser("hypersonic3d",
                       help="3-D hypersonic flow (tau_hypersonic_3d_cuda)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--view", default="schlieren")
    p.add_argument("--outflow", choices=("transmissive", "characteristic"),
                   default="transmissive")
    _common(p, 100)
    p.set_defaults(fn=cmd_hypersonic3d)

    p = sub.add_parser("th3cs", help=".4spl volume-video export (th3cs)")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--out", default="tau_hypersonic.4spl")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--serve", action="store_true",
                   help="stream frames to the web viewer while the "
                        "solver runs (prints the live URL)")
    p.add_argument("--port", type=int, default=0,
                   help="--serve HTTP port (0 = pick a free one)")
    p.set_defaults(fn=cmd_th3cs)

    p = sub.add_parser("mhd", help="ideal MHD + GLM cleaning (tau_mhd)")
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=220)
    p.add_argument("--case", default="briowu",
                   choices=["briowu", "orszag-tang"])
    p.add_argument("--view", type=int, default=0)
    p.add_argument("--stable-hll", action="store_true")
    _common(p, 200)
    p.set_defaults(fn=cmd_mhd)

    p = sub.add_parser("stam2d", help="stable fluids log-eta grid (js_cuda)")
    p.add_argument("--n", type=int, default=512)
    _common(p, 100)
    p.set_defaults(fn=cmd_stam2d)

    p = sub.add_parser("stam3d", help="3-D stable fluids (js_cuda3d)")
    p.add_argument("--n", type=int, default=192)
    # physics / seeding (js_cuda3d.cu getopt: dt/visc/diff/decay/amp/noise/
    # dens-amp/sigma/src-gain/src-freq)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--visc", type=float, default=1e-5)
    p.add_argument("--diff", type=float, default=1e-6)
    p.add_argument("--decay", type=float, default=0.9)
    p.add_argument("--amp", type=float, default=1.2,
                   help="ABC-flow seed amplitude")
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--dens-amp", type=float, default=0.8, dest="dens_amp")
    p.add_argument("--sigma", type=float, default=0.12)
    p.add_argument("--src-gain", type=float, default=0.25, dest="src_gain")
    p.add_argument("--src-freq", type=float, default=0.02, dest="src_freq")
    p.add_argument("--jacobi", type=int, default=12)
    p.add_argument("--seed", type=int, default=1337)
    # iso-splat tone map (js_cuda3d.cu getopt: gain/gamma/levels)
    p.add_argument("--gain", type=float, default=0.2)
    p.add_argument("--gamma", type=float, default=1.2)
    p.add_argument("--levels", type=int, default=256)
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--advect-k", type=int, default=0,
                   help="0 = exact gather advection (default); K >= 1 "
                        "= dense-shift advection, exact for backtraces <= "
                        "K cells (capped cells are reported)")
    p.add_argument("--colors", choices=("mono", "256"), default="mono",
                   help="256 = dynamic-palette ANSI renderer "
                        "(js_cuda3d.cu:471-517)")
    _common(p, 20)
    p.set_defaults(fn=cmd_stam3d)

    p = sub.add_parser("sph", help="weakly-compressible SPH (tau_sph)")
    p.add_argument("--n", type=int, default=1 << 16)
    p.add_argument("--box", type=float, default=1.0,
                   help="square domain side (tau_sph.cu --box)")
    p.add_argument("--rho0", type=float, default=1.0)
    p.add_argument("--c0", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0,
                   help="Tait EOS exponent (tau_sph.cu --gamma)")
    p.add_argument("--gravity", type=float, default=9.81)
    p.add_argument("--dTau", type=float, default=1.0)
    p.add_argument("--CFL", type=float, default=1.0)
    p.add_argument("--visc", type=float, default=0.25)
    p.add_argument("--visc_substeps", type=int, default=1)
    p.add_argument("--xsph", action="store_true",
                   help="enable XSPH velocity smoothing (k_xsph_cell)")
    p.add_argument("--xsph-eps", type=float, default=0.25, dest="xsph_eps")
    p.add_argument("--seed", type=int, default=69420)
    p.add_argument("--no-rain", action="store_true")
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--engine", choices=("xla", "exact"), default="xla",
                   help="xla = cell-dense neighbor lists (capped at "
                        "--bin-capacity per cell); exact = O(n^2) "
                        "all-pairs, correct at any occupancy")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    _common(p, 100)
    p.set_defaults(fn=cmd_sph)

    p = sub.add_parser("flip", help="FLIP/APIC hybrid fluid (tau_flip_apic)")
    p.add_argument("--particles", type=int, default=1 << 16)
    p.add_argument("--grid", type=int, default=128)
    p.add_argument("--jacobi", type=int, default=48)
    p.add_argument("--dt", type=float, default=0.004)
    p.add_argument("--gravity", type=float, default=7.5)
    p.add_argument("--flip", type=float, default=0.97)
    p.add_argument("--apic", type=float, default=0.85)
    p.add_argument("--engine", choices=("dense", "scatter"), default="dense",
                   help="transfer engine: cell-dense (capped per cell) or "
                        "scatter (the reference's atomic P2G, exact)")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    _common(p, 200)
    p.set_defaults(fn=cmd_flip)

    p = sub.add_parser("mpm", help="MLS-MPM elastoplastic (tau_mpm)")
    p.add_argument("--n", type=int, default=1 << 15)
    p.add_argument("--gx", type=int, default=96)
    p.add_argument("--gy", type=int, default=96)
    p.add_argument("--dt", type=float, default=8e-5)
    p.add_argument("--gravity", type=float, default=9.81)
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--material", default="snow",
                   choices=["mud", "snow", "sand"])
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--engine", choices=("dense", "scatter"),
                   default="scatter",
                   help="transfer engine: scatter (the reference's atomic "
                        "P2G, exact) or cell-dense (capped per cell)")
    p.add_argument("--bin-capacity", type=int, default=0, dest="bin_capacity",
                   help="cell-dense slots per cell (0 = auto); particles "
                        "beyond it are dropped and reported")
    _common(p, 500)
    p.set_defaults(fn=cmd_mpm)

    p = sub.add_parser("regression",
                       help="snapshot regression gate "
                            "(tau_hypersonic_cuda_tests)")
    p.add_argument("--nx", type=int, default=2048)
    p.add_argument("--ny", type=int, default=1024)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--baseline", default="hypersonic2d_baseline.txt")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--write-baseline", action="store_true")
    g.add_argument("--verify-baseline", action="store_true", default=True)
    p.set_defaults(fn=cmd_regression)

    p = sub.add_parser("hypersonic2d-cpu",
                       help="CPU reference 2-D hypersonic solver "
                            "(tau_hypersonic / tau_hypersonic_simd)")
    p.add_argument("--nx", type=int, default=300)
    p.add_argument("--ny", type=int, default=300)
    p.add_argument("--gamma", type=float, default=1.4)
    p.add_argument("--cfl", type=float, default=0.3)
    p.add_argument("--mach", type=float, default=15.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--native", action="store_true",
                   help="use the C build (bitwise-equal to the NumPy path)")
    p.add_argument("--interactive", action="store_true",
                   help="accepted for symmetry with the other solvers; "
                        "warns and runs the batch oracle")
    p.set_defaults(fn=cmd_hypersonic2d_cpu)

    p = sub.add_parser("nbody",
                       help="prime-graph force layout (number_fluid2d/3d)")
    p.add_argument("--max-number", type=int, default=1 << 17)
    p.add_argument("--dims", type=int, default=2, choices=[2, 3])
    p.add_argument("--grid-res", type=int, default=32)
    p.add_argument("--native", action="store_true",
                   help="use the native threaded Barnes-Hut engine "
                        "(native/nbody_bh.c) instead of the JAX path")
    p.add_argument("--threads", type=int, default=None,
                   help="worker threads for --native (default: CPU count)")
    p.add_argument("--theta", type=float, default=0.75,
                   help="BH multipole acceptance for --native (0 = exact)")
    p.add_argument("--engine", choices=("exact", "grid"), default="exact",
                   help="repulsion: exact all-pairs (default) or "
                        "grid-monopole approximation")
    p.add_argument("--scheme", default="mint",
                   choices=("mint", "index", "log", "radius", "xor"),
                   help="point color scheme (number_fluid2d.c:146-161)")
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--no-color", action="store_true",
                   help="plain half-blocks without ANSI colors")
    _common(p, 100)
    p.set_defaults(fn=cmd_nbody)

    return ap


def main(argv=None):
    import jax

    from .core.platform import enable_compile_cache

    enable_compile_cache(jax)
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
