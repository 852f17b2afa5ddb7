"""`.4spl` palettized volume-video container (reader + writer).

The reference links against a `4splat.c` that is MISSING from its repo
(Makefile:96-97); this module reimplements the format natively from the
extern "C" declarations (th3cs.cu:21-63) and the viewer's parser
(viewer.html:67-96):

  header  (32 B): u32 magic, u8 version[4], u32 width, height, depth,
                  frames, pSize, flags   (little-endian; w at offset 8)
  palette (pSize * 48 B): 12 f32 per entry —
                  mu_x, sigma_x, mu_y, sigma_y, mu_z, sigma_z,
                  mu_t, sigma_t, r, g, b, alpha
  indices (width*height*depth*frames B): one palette byte per voxel,
                  frame-major, voxel order (z*height + y)*width + x
  footer  (16 B): u32 checksum, u64 idxoffset, u32 end

The footer's checksum algorithm is unspecified anywhere (viewer.html reads
only header+palette+indices), so this implementation defines it as CRC32 of
the index bytes; `end` is the sentinel 0x4C505334 ("4SPL").

A native C writer with the reference's exact extern "C" API lives in
native/fourspl.c (built via fluidsims_tpu.io.fourspl_native).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["MAGIC", "Splat4DVideo", "heat_palette", "write_4spl", "read_4spl"]

MAGIC = 0x4C505334          # "4SPL" little-endian
VERSION = (1, 0, 0, 0)
END_SENTINEL = 0x4C505334
FLAG_F32_PRECISION = 0x04   # th3cs.cu:1226 ("Float32 Precision")
HEADER_FMT = "<I4BIIIIII"   # 32 bytes
FOOTER_FMT = "<IQI"


@dataclass
class Splat4DVideo:
    width: int
    height: int
    depth: int
    frames: int
    palette: np.ndarray        # (pSize, 12) float32
    indices: np.ndarray        # (frames, depth, height, width) uint8
    flags: int = FLAG_F32_PRECISION
    version: tuple = VERSION

    @property
    def p_size(self) -> int:
        return self.palette.shape[0]

    def colors(self) -> np.ndarray:
        """(pSize, 4) rgba from the palette records."""
        return self.palette[:, 8:12]


def heat_palette(p_size: int = 256) -> np.ndarray:
    """Thermal palette black->red->yellow->white (th3cs.cu:1144-1150), as
    (pSize, 12) Splat4D records with unit sigmas."""
    t = np.arange(p_size) / (p_size - 1.0)
    r = np.minimum(1.0, t * 2.5)
    g = np.clip(t * 2.5 - 0.5, 0.0, 1.0)
    b = np.clip(t * 2.5 - 1.5, 0.0, 1.0)
    pal = np.zeros((p_size, 12), np.float32)
    pal[:, 1] = pal[:, 3] = pal[:, 5] = pal[:, 7] = 1.0  # sigmas
    pal[:, 8] = r
    pal[:, 9] = g
    pal[:, 10] = b
    pal[:, 11] = 1.0
    return pal


def write_4spl(path, video: Splat4DVideo) -> None:
    idx = np.ascontiguousarray(video.indices, dtype=np.uint8)
    assert idx.shape == (video.frames, video.depth, video.height, video.width)
    pal = np.ascontiguousarray(video.palette, dtype=np.float32)

    header = struct.pack(
        HEADER_FMT, MAGIC, *video.version,
        video.width, video.height, video.depth, video.frames,
        video.p_size, video.flags,
    )
    idx_bytes = idx.tobytes()
    idxoffset = len(header) + pal.nbytes
    footer = struct.pack(
        FOOTER_FMT, zlib.crc32(idx_bytes) & 0xFFFFFFFF, idxoffset,
        END_SENTINEL,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(pal.tobytes())
        f.write(idx_bytes)
        f.write(footer)


def read_4spl(path) -> Splat4DVideo:
    with open(path, "rb") as f:
        data = f.read()
    (magic, v0, v1, v2, v3, w, h, d, frames, p_size, flags) = struct.unpack(
        HEADER_FMT, data[:32]
    )
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:08x}")
    pal = np.frombuffer(data, np.float32, count=p_size * 12, offset=32)
    pal = pal.reshape(p_size, 12).copy()
    idx_off = 32 + p_size * 48
    n_vox = w * h * d * frames
    idx = np.frombuffer(data, np.uint8, count=n_vox, offset=idx_off)
    idx = idx.reshape(frames, d, h, w).copy()
    return Splat4DVideo(width=w, height=h, depth=d, frames=frames,
                        palette=pal, indices=idx, flags=flags,
                        version=(v0, v1, v2, v3))


def gamma_thresholds(gamma: float = 0.65, levels: int = 256) -> np.ndarray:
    """tau_k = (k/(levels-1))**(1/gamma) for k = 1..levels-1, computed in
    f64 and rounded once to f32.  index(v) = #{k : v_norm >= tau_k}
    reproduces trunc(v_norm**gamma * 255) up to one index at
    representation boundaries, with NO pow or divide in the per-voxel
    path — which is what makes the host (NumPy) and device (XLA)
    quantizers byte-identical (device f32 division may be reciprocal-based
    and pow is transcendental; sub/mul/compare are exactly rounded on
    both)."""
    k = np.arange(1, levels, dtype=np.float64)
    return ((k / (levels - 1)) ** (1.0 / gamma)).astype(np.float32)


def quantize_frame(field: np.ndarray, gamma: float = 0.65) -> np.ndarray:
    """Per-frame min/max normalize + gamma + 8-bit quantize
    (th3cs.cu:1199-1222), as a threshold comparison (gamma_thresholds)."""
    f = np.asarray(field, np.float32)
    mn = f.min()
    rng = np.maximum(np.float32(f.max() - mn), np.float32(1e-12))
    ts = gamma_thresholds(gamma) * rng          # f32 multiplies
    idx = np.searchsorted(ts, (f - mn).ravel(), side="right")
    return idx.astype(np.uint8).reshape(f.shape)


def quantize_frame_device(field, gamma: float = 0.65):
    """quantize_frame on-device (jnp): byte-identical to the host version
    — both count the same f32 threshold comparisons (th3cs.cu computes
    schlieren on-device, :641, and quantizes in C, :1199-1222; here both
    stages stay on-device and only uint8 indices cross the host link)."""
    import jax.numpy as jnp

    f = field.astype(jnp.float32)
    mn = jnp.min(f)
    rng = jnp.maximum(jnp.max(f) - mn, jnp.float32(1e-12))
    ts = jnp.asarray(gamma_thresholds(gamma)) * rng
    idx = jnp.sum((f - mn)[..., None] >= ts, axis=-1, dtype=jnp.int32)
    return idx.astype(jnp.uint8)
