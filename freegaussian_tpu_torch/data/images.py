"""Image files of the datasets, read as `imageio.v2.imread` reads them (the
JAX package's reader; the GPU machine has no imageio).

PNG goes to the port's own decoder (`viewer/png.py`); every other format
(JPEG, as real captures in nerfstudio's layout have) goes to Pillow, which
is what imageio decodes them with, so the pixels are the same. Pillow is
imported at the first such file.
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from ..viewer.png import _SIGNATURE, decode_png


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading a non-PNG image needs Pillow (PIL), which is not installed") from e
    return Image


def read_image(path) -> np.ndarray:
    """(H, W) gray or (H, W, C) uint8 pixels of an image file: gray stays
    2-D (the datamanager stacks it to RGB, as the JAX package's does), and
    nothing is rotated by its EXIF orientation."""
    data = Path(path).read_bytes()
    if data[:8] == _SIGNATURE:
        return decode_png(data)
    with _pillow().open(io.BytesIO(data)) as im:
        return np.array(im)


def image_size(path) -> Tuple[int, int]:
    """(height, width) of an image file, from its header."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _SIGNATURE:  # IHDR: width, height big-endian after the chunk header
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    with _pillow().open(path) as im:
        w, h = im.size
    return h, w
