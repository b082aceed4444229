"""PNG encoding and decoding with the standard library (zlib + struct).

`decode_png` (and `read_png` for a file) is the port's counterpart of
`imageio.imread` for the datasets' PNG images (the GPU machine has no
imageio): 8-bit gray, gray + alpha, RGB, RGBA and palette, non-interlaced,
every row filter. `encode_png` writes the render verb's and eval dumps'
frames.
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


# color type -> channels of an 8-bit, non-interlaced image
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) of `raw` (height, 1 + stride) uint8; returns (height, stride)."""
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(raw[y, 0])
        line = raw[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # a running sum along each channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):  # sequential along the row
            cur = bytearray(stride)
            up = prior.tolist()
            vals = line.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (vals[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray, gray + alpha, RGB, RGBA or palette,
    non-interlaced, any of the five row filters) -> uint8 (H, W) for gray,
    else (H, W, C) with C = 2, 3 or 4, as `imageio.imread` returns them (a
    palette image as RGB, or RGBA when it has a tRNS chunk). Checks the
    signature and every chunk's CRC; raises on anything else (other bit
    depths, interlacing)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    idat = []
    header = palette = alpha = None
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
            if depth != 8 or (ctype not in _CHANNELS and ctype != 3) or interlace != 0:
                raise ValueError(
                    f"only 8-bit gray, gray + alpha, RGB, RGBA or palette non-interlaced PNG is supported "
                    f"(bit depth {depth}, color type {ctype}, interlace {interlace})"
                )
            header = (width, height, _CHANNELS.get(ctype, 1), ctype == 3)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, channels, indexed = header
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"PNG image data holds {raw.size} bytes, want {height * (1 + stride)}")
    img = _unfilter(raw.reshape(height, 1 + stride), height, stride, channels)
    if indexed:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        table = palette
        if alpha is not None:
            table = np.concatenate([palette, np.full((len(palette), 1), 255, np.uint8)], axis=1)
            table[: len(alpha), 3] = alpha[: len(palette)]
        return table[img.reshape(height, width)]
    return img.reshape(height, width) if channels == 1 else img.reshape(height, width, channels)


def read_png(path) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read())
