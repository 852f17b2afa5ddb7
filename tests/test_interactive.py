"""Key-driven interactive loop (core/interactive.py): the reference's L4
pause/reset/view-cycle/param-nudge contract, tested with scripted keys."""

import io

import jax
import numpy as np

from fluidsims_tpu.core.interactive import interactive_loop


class _Keys:
    """Scripted key source: yields one queued burst per poll."""

    def __init__(self, bursts):
        self.bursts = list(bursts)

    def __call__(self):
        return self.bursts.pop(0) if self.bursts else ""


def _counter_runner():
    calls = {"built": 0}

    def make_runner():
        calls["built"] += 1

        def run(state, n):
            return state + n

        return run

    return make_runner, calls


def test_loop_advances_and_stops_at_max_steps():
    make_runner, _ = _counter_runner()
    out = io.StringIO()
    final = interactive_loop(
        0, make_runner, lambda s: f"[{s}]", {}, stride=2, max_steps=6,
        input_fn=_Keys([]), out=out, fps_cap=0)
    assert final == 6
    assert "[6]" in out.getvalue()


def test_quit_key_stops_early():
    make_runner, _ = _counter_runner()
    final = interactive_loop(
        0, make_runner, str, {}, stride=1, max_steps=100,
        input_fn=_Keys(["", "", "q"]), out=io.StringIO(), fps_cap=0)
    assert final == 2  # two frames before the quit poll


def test_pause_and_step_once():
    make_runner, _ = _counter_runner()
    keys = {
        "p": ("pause", lambda ctx: setattr(ctx, "paused", not ctx.paused)),
        " ": ("step", lambda ctx: setattr(ctx, "step_once", True)),
    }
    # advance 1, pause for 2 polls, single-step once, quit
    final = interactive_loop(
        0, make_runner, str, keys, stride=1, max_steps=100,
        input_fn=_Keys(["", "p", "", " ", "q"]), out=io.StringIO(),
        fps_cap=0)
    # frames: +1 (run), pause (no step), idle (no step), step_once (+1)
    assert final == 2


def test_invalidate_rebuilds_runner():
    make_runner, calls = _counter_runner()
    keys = {"n": ("nudge", lambda ctx: ctx.invalidate())}
    interactive_loop(
        0, make_runner, str, keys, stride=1, max_steps=3,
        input_fn=_Keys(["", "n", ""]), out=io.StringIO(), fps_cap=0)
    assert calls["built"] == 2  # initial + one rebuild


def test_cli_interactive_smoke(monkeypatch, capsys):
    """End-to-end: sph/lbm/hypersonic2d --interactive run to completion
    with a non-tty stdin (RawStdin degrades to no keys)."""
    from fluidsims_tpu.cli import main

    main(["sph", "--n", "256", "--steps", "4", "--stride", "2",
          "--interactive"])
    out = capsys.readouterr().out
    assert "step 4" in out
    assert "[p]pause" in out and "[>]dTau+" in out

    main(["lbm", "--nx", "32", "--ny", "16", "--steps", "4", "--stride", "2",
          "--interactive"])
    out = capsys.readouterr().out
    assert "[o]obstacle" in out

    main(["hypersonic2d", "--nx", "64", "--ny", "32", "--steps", "2",
          "--stride", "1", "--interactive"])
    out = capsys.readouterr().out
    assert "[m]view" in out


def test_stride_nudge_keys():
    """ctx.stride halving/doubling (the reference's +/- publish-stride
    keys, number_fluid2d.c:814-820)."""
    make_runner, _ = _counter_runner()
    keys = {
        "+": ("s*2", lambda ctx: setattr(ctx, "stride",
                                         min(ctx.stride * 2, 64))),
        "-": ("s/2", lambda ctx: setattr(ctx, "stride",
                                         max(ctx.stride // 2, 1))),
    }
    # stride 2 -> frame(+2) -> '+': stride 4 -> frame(+4) -> quit
    final = interactive_loop(
        0, make_runner, str, keys, stride=2, max_steps=100,
        input_fn=_Keys(["", "+", "q"]), out=io.StringIO(), fps_cap=0)
    assert final == 6


def test_cli_nbody_live_smoke(monkeypatch, capsys):
    """nbody --render --stride N animates live in 2-D and 3-D (the
    reference's continuous draw loops, number_fluid2d.c:805-888 and
    number_fluid3d.c:909-958)."""
    from fluidsims_tpu.cli import main

    main(["nbody", "--max-number", "512", "--steps", "4", "--stride", "2",
          "--render", "--cols", "40", "--rows", "12"])
    out = capsys.readouterr().out
    assert "step 4" in out
    assert "[r]refit" in out and "[h]pan-l" in out and "zoom=" in out

    main(["nbody", "--max-number", "512", "--dims", "3", "--steps", "4",
          "--stride", "2", "--render", "--cols", "40", "--rows", "12"])
    out = capsys.readouterr().out
    assert "[a]yaw-" in out and "pitch=" in out


def test_nbody_live_camera_keys():
    """Scripted pan/zoom/orbit/scheme keys mutate the live camera."""
    import numpy as np

    from fluidsims_tpu.render import points as rp

    rng = np.random.default_rng(0)
    pos = rng.normal(size=(256, 3)) * 50

    cam = rp.camera_fit(pos[:, :2], 40, 12)
    z0 = cam.zoom
    cam.zoom *= 1.12
    f1 = rp.render_points(pos[:, :2], 40, 12, camera=cam)
    cam.zoom = z0
    f2 = rp.render_points(pos[:, :2], 40, 12, camera=cam)
    assert f1 != f2

    oc = rp.fit_orbit(pos)
    fa = rp.render_points_3d(pos, 40, 12, camera=oc)
    oc.yaw += 0.5
    fb = rp.render_points_3d(pos, 40, 12, camera=oc)
    assert fa != fb


def test_cli_interactive_everywhere_smoke(capsys):
    """Round 3: every remaining solver accepts --interactive with the
    common pause/step/reset keys plus its reference extras
    (tau_hypersonic_3d_cuda.cu:1645-1672, tau_mhd.c:190-193)."""
    from fluidsims_tpu.cli import main

    cases = [
        (["burgers", "--nx", "32", "--ny", "16"], "[m]view"),
        (["shallow-water", "--nx", "32", "--ny", "16"], "[m]view"),
        (["gray-scott", "--nx", "32", "--ny", "16"], "[F]F+"),
        (["mhd", "--nx", "32", "--ny", "17"], "[c]problem"),
        (["stam2d", "--n", "32"], "[r]reset"),
        (["hypersonic3d", "--n", "16"], "[=]gain+"),
        (["mpm", "--n", "256", "--gx", "24", "--gy", "24"], "[m]material"),
        (["flip", "--particles", "256", "--grid", "24"], "[F]flip+"),
    ]
    for argv, marker in cases:
        main(argv + ["--steps", "2", "--stride", "1", "--interactive"])
        out = capsys.readouterr().out
        assert "step 2" in out, argv[0]
        assert marker in out, argv[0]


def test_traced_nudges_match_baked_config():
    """Shape-preserving scalar nudges ride as traced jit arguments (no
    recompile — the analog of the reference's instant keys, e.g.
    tau_sph.cu:642-655): overriding at call time must equal baking the
    same value into the config."""
    from dataclasses import replace

    from fluidsims_tpu.solvers import flip_apic as fa
    from fluidsims_tpu.solvers import lbm, sph

    # LBM drive
    cfg = lbm.LBMConfig(nx=32, ny=16)
    s = lbm.init(cfg)
    a = lbm.run(replace(cfg, drive=3e-6), s, 3)
    b = lbm.run(cfg, s, 3, drive=3e-6)
    assert np.array_equal(np.asarray(a.f), np.asarray(b.f))

    # SPH dtau (clock-level scalar; any engine)
    scfg = sph.SPHConfig(n=128, rain=False, engine="xla")
    ss = sph.init(scfg)
    sa = sph.run(replace(scfg, dtau=0.02), ss, 2)
    sb = sph.run(scfg, ss, 2, dtau=0.02)
    assert np.array_equal(np.asarray(sa.pos), np.asarray(sb.pos))

    # FLIP flip/apic blend factors (dense engine)
    fcfg = fa.FlipApicConfig(particles=256, grid=24, engine="dense")
    fs = fa.init(fcfg)
    faa = fa.run(replace(fcfg, flip=0.5, apic=0.3), fs, 2)
    fab = fa.run(fcfg, fs, 2, flip=0.5, apic=0.3)
    assert np.array_equal(np.asarray(faa.pos), np.asarray(fab.pos))
    assert np.array_equal(np.asarray(faa.vel), np.asarray(fab.vel))


def test_rawstdin_sigterm_restores_terminal():
    """`kill <pid>` during an interactive session must restore the
    terminal (cbreak off) and exit 128+SIGTERM — the js_cuda.cu:284-292
    signal-trap analog.  Runs a child under a real pty."""
    import os
    import pty
    import signal
    import sys
    import termios
    import time

    pid, master = pty.fork()
    if pid == 0:  # child: enter raw mode on the pty, then idle
        try:
            # pytest's capture replaces sys.stdin with a non-tty stub;
            # rebind it to the pty slave the fork put on fd 0
            sys.stdin = os.fdopen(0, "r")
            from fluidsims_tpu.core.interactive import RawStdin

            with RawStdin() as raw:
                assert raw._active, "child stdin must be the pty"
                os.write(1, b"R")  # ready marker
                time.sleep(30)
            os._exit(1)  # the sleep must be interrupted by the trap
        except SystemExit as e:
            os._exit(e.code if isinstance(e.code, int) else 1)
        except BaseException:
            os._exit(99)

    try:
        # wait for the child to enter raw mode
        deadline = time.time() + 20
        got = b""
        while b"R" not in got and time.time() < deadline:
            try:
                got += os.read(master, 1)
            except OSError:
                break
        assert b"R" in got, "child never entered raw mode"
        attrs = termios.tcgetattr(master)
        assert not (attrs[3] & termios.ICANON), "cbreak must be active"

        os.kill(pid, signal.SIGTERM)
        _, status = os.waitpid(pid, 0)
        assert os.waitstatus_to_exitcode(status) == 128 + signal.SIGTERM
        attrs = termios.tcgetattr(master)
        assert attrs[3] & termios.ICANON, "terminal must be restored"
        assert attrs[3] & termios.ECHO
    finally:
        os.close(master)
