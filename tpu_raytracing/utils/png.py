"""PNG output for render results (parity: raytracing-cpu/src/utils.rs:7-47).

Linear radiance -> 8-bit with an exposure divisor; gamma is recorded via the
PNG gAMA chunk like the reference (gamma 1/2.2), i.e. pixel values stay
linear after the exposure divide and viewers apply the display gamma.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

F = np.float32

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# gAMA stores gamma * 100000: the reference's 1/2.2
GAMA = 45455


def _to_u8(linear: np.ndarray, exposure: float) -> np.ndarray:
    scaled = np.clip(np.asarray(linear, F) / F(exposure), 0.0, 1.0)
    return (scaled * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes: IHDR (8-bit RGB), gAMA, one
    zlib-compressed IDAT of filter-0 scanlines, IEND."""
    u8 = np.ascontiguousarray(u8, np.uint8)
    h, w, c = u8.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {u8.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)], axis=1
    )
    return b"".join([
        PNG_SIGNATURE,
        _chunk(b"IHDR", ihdr),
        _chunk(b"gAMA", struct.pack(">I", GAMA)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def save_png(path, rgb: np.ndarray, exposure: float = 1.0) -> None:
    """Save (H, W, 3) linear float RGB with an exposure divisor + gAMA chunk."""
    with open(path, "wb") as f:
        f.write(encode_png(_to_u8(rgb, exposure)))


def normals_to_rgb(normals: np.ndarray) -> np.ndarray:
    """Map [-1, 1] normals to [0, 1] rgb."""
    return (np.asarray(normals, F) * 0.5 + 0.5).astype(F)


def uvs_to_rgb(uvs: np.ndarray) -> np.ndarray:
    """(H, W, 2) uv -> rgb with zero blue channel."""
    uvs = np.asarray(uvs, F)
    return np.concatenate(
        [uvs, np.zeros((*uvs.shape[:2], 1), F)], axis=-1
    )
