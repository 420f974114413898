"""PNG writer on the standard library (utils/png.py)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

from tpu_raytracing.utils.png import GAMA, PNG_SIGNATURE, save_png


def _chunks(data: bytes):
    assert data[:8] == PNG_SIGNATURE
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        out.append((kind, body))
        pos += 12 + n
    return out


def test_png_scanlines_and_gamma(tmp_path):
    rng = np.random.default_rng(0)
    h, w = 5, 7
    rgb = rng.uniform(-0.2, 1.3, (h, w, 3)).astype(np.float32) * 1000.0
    path = tmp_path / "out.png"
    save_png(path, rgb, exposure=1000.0)
    chunks = _chunks(path.read_bytes())
    kinds = [k for k, _ in chunks]
    assert kinds == [b"IHDR", b"gAMA", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (w, h, 8, 2, 0, 0, 0)
    assert struct.unpack(">I", chunks[1][1]) == (GAMA,) == (45455,)
    raw = zlib.decompress(chunks[2][1])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(rows[:, 0] == 0)  # filter type 0 on every scanline
    expected = (np.clip(rgb / 1000.0, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3), expected)
    assert chunks[3][1] == b""


def test_png_single_pixel(tmp_path):
    path = tmp_path / "one.png"
    save_png(path, np.ones((1, 1, 3), np.float32))
    chunks = _chunks(path.read_bytes())
    raw = zlib.decompress(chunks[2][1])
    assert raw == b"\x00\xff\xff\xff"
