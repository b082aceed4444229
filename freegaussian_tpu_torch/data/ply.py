"""Minimal PLY point-cloud reader (twin of `freegaussian_tpu/data/ply.py:read_ply_points`):
ascii and binary little-endian, x/y/z and optional red/green/blue vertex
properties, the subset the reference uses for SfM seed points."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_points(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (xyz (N, 3) float32, rgb (N, 3) uint8 or None)."""
    path = Path(path)
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n_vertex = 0
        props = []  # (name, dtype) of the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header without end_header")
            parts = line.strip().decode("ascii").split()
            if parts == ["end_header"]:
                break
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties not supported in vertex element")
                props.append((parts[2], _DTYPES[parts[1]]))

        if fmt == "ascii":
            data = np.atleast_2d(np.loadtxt(f, max_rows=n_vertex))
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(name, "<" + d) for name, d in props])
            arr = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype, count=n_vertex)
            rec = {name: arr[name] for name, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    rgb = None
    if all(k in rec for k in ("red", "green", "blue")):
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1).astype(np.uint8)
    return xyz, rgb
