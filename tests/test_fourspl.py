"""`.4spl` format tests: roundtrip, byte layout per viewer.html, native/
Python writer equivalence, and the th3cs export pipeline."""

import struct

import numpy as np

from fluidsims_tpu.io import fourspl
from fluidsims_tpu.io.fourspl_native import native_available, write_4spl_native


def tiny_video(frames=3, d=4, h=5, w=6, seed=0):
    rng = np.random.default_rng(seed)
    return fourspl.Splat4DVideo(
        width=w, height=h, depth=d, frames=frames,
        palette=fourspl.heat_palette(256),
        indices=rng.integers(0, 256, (frames, d, h, w), dtype=np.uint8),
    )


def test_roundtrip(tmp_path):
    v = tiny_video()
    p = tmp_path / "a.4spl"
    fourspl.write_4spl(p, v)
    r = fourspl.read_4spl(p)
    assert (r.width, r.height, r.depth, r.frames) == (6, 5, 4, 3)
    np.testing.assert_array_equal(r.indices, v.indices)
    np.testing.assert_allclose(r.palette, v.palette)


def test_byte_layout_matches_viewer(tmp_path):
    """Parse the file exactly like viewer.html:67-96 does."""
    v = tiny_video()
    p = tmp_path / "b.4spl"
    fourspl.write_4spl(p, v)
    data = p.read_bytes()

    width = struct.unpack_from("<I", data, 8)[0]
    height = struct.unpack_from("<I", data, 12)[0]
    depth = struct.unpack_from("<I", data, 16)[0]
    frames = struct.unpack_from("<I", data, 20)[0]
    p_size = struct.unpack_from("<I", data, 24)[0]
    assert (width, height, depth, frames, p_size) == (6, 5, 4, 3, 256)

    # palette rgb at entry offsets +32..+40 (viewer.html:80-86)
    p_off = 32
    r0 = struct.unpack_from("<f", data, p_off + 32)[0]
    assert r0 == v.palette[0, 8]
    r_last = struct.unpack_from("<f", data, p_off + 255 * 48 + 32)[0]
    np.testing.assert_allclose(r_last, 1.0)

    # indices start right after the palette, 1 byte/voxel
    idx_off = 32 + p_size * 48
    voxels = width * height * depth * frames
    got = np.frombuffer(data, np.uint8, voxels, idx_off)
    np.testing.assert_array_equal(got, v.indices.ravel())

    # footer: u32 checksum, u64 idxoffset, u32 end
    foot = data[idx_off + voxels:]
    assert len(foot) == 16
    _, idxoffset, end = struct.unpack("<IQI", foot)
    assert idxoffset == idx_off
    assert end == fourspl.END_SENTINEL


def test_native_writer_bitwise_matches_python(tmp_path):
    if not native_available():
        import pytest

        pytest.skip("no C compiler for native writer")
    v = tiny_video(seed=3)
    p1 = tmp_path / "py.4spl"
    p2 = tmp_path / "nat.4spl"
    fourspl.write_4spl(p1, v)
    write_4spl_native(p2, v)
    assert p1.read_bytes() == p2.read_bytes()


def test_quantize_frame_gamma():
    f = np.linspace(0.0, 1.0, 256).reshape(16, 16)
    q = fourspl.quantize_frame(f, gamma=0.65)
    assert q.dtype == np.uint8
    assert q.min() == 0 and q.max() == 255
    # gamma < 1 brightens: midpoint maps above 127
    assert q[8, 0] > 127


def test_th3cs_export_small(tmp_path):
    from fluidsims_tpu.solvers import hypersonic3d as h3
    from fluidsims_tpu.solvers.th3cs import export_4spl

    cfg = h3.default_config(12)
    p = tmp_path / "vol.4spl"
    video = export_4spl(p, cfg, frames=2, steps_per_frame=1)
    r = fourspl.read_4spl(p)
    assert r.frames == 2 and r.width == 12
    np.testing.assert_array_equal(r.indices, video.indices)


def test_quantize_device_matches_host_bytes():
    """The on-device quantizer must produce byte-identical indices to the
    host quantizer — the property that lets th3cs transfer 1 byte/voxel
    (threshold comparison, no pow/divide in the per-voxel path)."""
    import jax

    rng = np.random.default_rng(7)
    for shape in ((16, 16, 16), (8, 32, 8)):
        vol = (rng.random(shape, dtype=np.float32) * rng.uniform(0.1, 50)
               + rng.uniform(-5, 5)).astype(np.float32)
        host = fourspl.quantize_frame(vol, gamma=0.65)
        dev = np.asarray(jax.jit(
            lambda v: fourspl.quantize_frame_device(v, 0.65))(vol))
        np.testing.assert_array_equal(host, dev)
    # exact-boundary values: v_norm landing on representable thresholds
    tau = fourspl.gamma_thresholds(0.65)
    vol = np.concatenate([tau, tau, np.array([0.0, 1.0], np.float32)])
    vol = vol.reshape(1, 16, -1)
    host = fourspl.quantize_frame(vol, gamma=0.65)
    dev = np.asarray(jax.jit(
        lambda v: fourspl.quantize_frame_device(v, 0.65))(vol))
    np.testing.assert_array_equal(host, dev)


def test_streamed_export_matches_batch_and_is_readable_mid_write(tmp_path):
    """The streaming writer must (a) produce a file byte-identical to the
    batch export after finish(), and (b) present a valid, frame-clamped
    stream to a reader that catches it mid-append (the live viewer's
    poll)."""
    import numpy as np

    from fluidsims_tpu.io import fourspl
    from fluidsims_tpu.io.live4spl import Stream4splWriter, read_4spl_partial
    from fluidsims_tpu.solvers import hypersonic3d as h3
    from fluidsims_tpu.solvers.th3cs import export_4spl, export_4spl_streamed

    cfg = h3.default_config(16)
    batch = tmp_path / "batch.4spl"
    stream = tmp_path / "stream.4spl"
    export_4spl(batch, cfg, frames=3, steps_per_frame=2, use_native=False)

    seen = []

    def on_frame(i, total):
        seen.append(i)
        part = read_4spl_partial(stream)
        assert part.frames == i + 1          # published immediately
        assert part.width == part.height == part.depth == 16

    export_4spl_streamed(stream, cfg, frames=3, steps_per_frame=2,
                         on_frame=on_frame)
    assert seen == [0, 1, 2]
    assert batch.read_bytes() == stream.read_bytes()

    # a torn read (mid-frame bytes) clamps to the complete frames
    data = stream.read_bytes()
    torn = tmp_path / "torn.4spl"
    torn.write_bytes(data[: 32 + 256 * 48 + 2 * 16 ** 3 + 100])
    part = read_4spl_partial(torn)
    assert part.frames == 2
    full = fourspl.read_4spl(stream)
    np.testing.assert_array_equal(part.indices, full.indices[:2])

    # writer rejects wrong frame geometry
    with Stream4splWriter(tmp_path / "w.4spl", 4, 4, 4) as w:
        w.append(np.zeros((4, 4, 4), np.uint8))
        try:
            w.append(np.zeros((5, 4, 4), np.uint8))
            raise SystemExit("shape mismatch must be rejected")
        except AssertionError:
            pass


def test_live_server_serves_viewer_and_growing_stream(tmp_path):
    """`serve_dir` must serve the viewer page and the stream file with
    caching disabled, and re-serve the grown file on re-fetch."""
    import pathlib
    import urllib.request

    import numpy as np

    from fluidsims_tpu.io.live4spl import Stream4splWriter, serve_dir

    viewer = (pathlib.Path(__file__).resolve().parent.parent
              / "viewer" / "index.html")
    (tmp_path / "index.html").write_bytes(viewer.read_bytes())

    srv, _ = serve_dir(tmp_path, 0)
    try:
        port = srv.server_address[1]

        def get(name):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/{name}") as r:
                return r.status, dict(r.headers), r.read()

        st, hdr, body = get("index.html")
        assert st == 200 and b"live" in body
        assert "no-store" in hdr.get("Cache-Control", "")

        w = Stream4splWriter(tmp_path / "volume.4spl", 4, 4, 4)
        w.append(np.full((4, 4, 4), 7, np.uint8))
        st, _, body1 = get("volume.4spl")
        assert st == 200
        w.append(np.full((4, 4, 4), 9, np.uint8))
        st, _, body2 = get("volume.4spl")
        assert len(body2) == len(body1) + 64   # the new frame is visible
        w.finish()
    finally:
        srv.shutdown()
