"""PNG encoding and decoding with the standard library (zlib + struct).

The viewer serves PNG where the JAX package serves JPEG: the GPU machine has
no imageio, PIL or torchvision. `decode_png` reads back what `encode_png`
writes (8-bit RGB, non-interlaced, row filter 0), which is what the checks
need.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(rgb8: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (filter type 0 on every row)."""
    rgb8 = np.ascontiguousarray(rgb8, dtype=np.uint8)
    if rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb8.shape}")
    h, w, _ = rgb8.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb8.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, non-interlaced) -> (H, W, 3) uint8. Checks the
    signature and every chunk's CRC."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    idat = []
    width = height = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            width, height, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB non-interlaced PNG is supported")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if width is None:
        raise ValueError("PNG without IHDR")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, 1 + 3 * width)
    if np.any(raw[:, 0] != 0):
        raise ValueError("only PNG filter type 0 (as encode_png writes) is supported")
    return raw[:, 1:].reshape(height, width, 3).copy()
