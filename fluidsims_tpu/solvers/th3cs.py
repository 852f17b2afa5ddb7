"""Headless 3-D hypersonic run exporting a schlieren `.4spl` volume video.

Behavioral spec: th3cs.cu — the same Params/physics as
tau_hypersonic_3d_cuda.cu (solvers/hypersonic3d.py) run headless for 60
frames x 4 steps (:1132-1134), schlieren |grad rho| per frame
(k_schlieren_export :641-673 — identical to the viewer's schlieren mode),
256-entry heat palette (:1144-1150), per-frame min/max normalization with
gamma 0.65 and 8-bit quantization (:1199-1222), written with header flags
0x0004 (:1226-1228) via the 4splat API (io/fourspl*).
"""

from __future__ import annotations

import jax
import numpy as np

from ..io import fourspl
from ..io.fourspl_native import write_4spl_best
from . import hypersonic3d as h3

__all__ = ["export_4spl", "export_4spl_streamed", "stream_frames"]


def _make_frame_fn(cfg, steps_per_frame: int):
    """Build the per-frame fused dispatch: steps -> schlieren -> on-device
    gamma-0.65 quantization; only uint8 indices cross the host link."""
    from ..core.stepper import scan_steps

    def frame_fn(s):
        s2 = scan_steps(lambda st: h3.step(cfg, st), s, steps_per_frame)
        vol = h3.vis_field(cfg, s2, "schlieren")
        return s2, fourspl.quantize_frame_device(vol, gamma=0.65)

    return jax.jit(frame_fn)


def export_4spl(
    path,
    cfg: h3.Hypersonic3DConfig | None = None,
    frames: int = 60,
    steps_per_frame: int = 4,
    p_size: int = 256,
    use_native: bool = True,
    verbose: bool = False,
) -> fourspl.Splat4DVideo:
    """Run the 3-D solver and export the schlieren volume video."""
    cfg = cfg or h3.default_config()
    state = h3.init(cfg)

    # one fused dispatch per frame; a small window of frames stays in
    # flight so transfers overlap compute (the reference's
    # one-readback-per-frame discipline, made async)
    frame_fn = _make_frame_fn(cfg, steps_per_frame)

    # bounded dispatch window: keep a few frames in flight so host
    # transfers overlap device compute, without pinning every quantized
    # frame on device at once (a 256^3 x 240-frame export would otherwise
    # hold ~4 GB of pending buffers)
    window = 4
    pending = []
    indices = np.empty((frames, cfg.nz, cfg.ny, cfg.nx), np.uint8)

    def collect(f, qf):
        indices[f] = np.asarray(qf)
        if verbose:
            print(f"frame {f + 1}/{frames}")

    for f in range(frames):
        state, qf = frame_fn(state)
        pending.append((f, qf))
        if len(pending) >= window:
            collect(*pending.pop(0))
    for f, qf in pending:
        collect(f, qf)

    video = fourspl.Splat4DVideo(
        width=cfg.nx, height=cfg.ny, depth=cfg.nz, frames=frames,
        palette=fourspl.heat_palette(p_size), indices=indices,
        flags=fourspl.FLAG_F32_PRECISION,
    )
    if use_native:
        write_4spl_best(path, video)
    else:
        fourspl.write_4spl(path, video)
    return video


def export_4spl_streamed(
    path,
    cfg: h3.Hypersonic3DConfig | None = None,
    frames: int = 60,
    steps_per_frame: int = 4,
    p_size: int = 256,
    verbose: bool = False,
    on_frame=None,
) -> None:
    """Run the 3-D solver and stream the schlieren video: each frame is
    appended to `path` (and published via the header frame count) the
    moment it lands, so a polling viewer (viewer/index.html?live=1) shows
    the shock forming while the solver runs.  After the final frame the
    footer is written and the file is byte-identical to `export_4spl`'s.

    `on_frame(i, total)` fires after frame i is on disk."""
    from ..io.live4spl import Stream4splWriter

    cfg = cfg or h3.default_config()
    state = h3.init(cfg)
    frame_fn = _make_frame_fn(cfg, steps_per_frame)

    with Stream4splWriter(path, cfg.nx, cfg.ny, cfg.nz,
                          fourspl.heat_palette(p_size)) as wtr:
        stream_frames(frame_fn, state, frames, wtr, verbose=verbose,
                      on_frame=on_frame)


def stream_frames(frame_fn, state, frames: int, wtr, verbose: bool = False,
                  on_frame=None, window: int = 4):
    """Drive `frame_fn(state) -> (state, uint8 volume)` for `frames`
    frames, appending each to stream writer `wtr` (any solver's live
    stream uses this).  A `window`-deep dispatch queue keeps device
    compute and host transfers overlapped."""
    pending = []

    def collect(f, qf):
        wtr.append(np.asarray(qf))
        if verbose:
            print(f"frame {f + 1}/{frames} streamed")
        if on_frame is not None:
            on_frame(f, frames)

    for f in range(frames):
        state, qf = frame_fn(state)
        pending.append((f, qf))
        if len(pending) >= window:
            collect(*pending.pop(0))
    for f, qf in pending:
        collect(f, qf)
    return state
