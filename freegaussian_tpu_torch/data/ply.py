"""Minimal PLY point clouds (twin of `freegaussian_tpu/data/ply.py`): the
reader takes ascii and binary little-endian, x/y/z and optional
red/green/blue vertex properties, the subset the reference uses for SfM seed
points; the writer gives binary little-endian (the cluster visualization,
and the seed points `create_ply_from_colmap` converts from a colmap model)."""

from __future__ import annotations

import struct
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


def write_ply_points(path, xyz: np.ndarray, rgb: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian point cloud: float x/y/z and, with `rgb`,
    uchar red/green/blue (the bytes of `freegaussian_tpu/data/ply.py:write_ply_points`)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    if rgb is not None:
        rgb = np.asarray(rgb, np.uint8)
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if rgb is None:
            f.write(xyz.astype("<f4").tobytes())
        else:
            rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")])
            rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
            f.write(rec.tobytes())


def read_colmap_points3d(recon_dir) -> Tuple[np.ndarray, np.ndarray]:
    """A colmap sparse model's points, from `points3D.bin` (else
    `points3D.txt`): (xyz (P, 3) float64, rgb (P, 3) uint8)."""
    recon_dir = Path(recon_dir)
    bin_path, txt_path = recon_dir / "points3D.bin", recon_dir / "points3D.txt"
    xyzs, rgbs = [], []
    if bin_path.exists():
        with open(bin_path, "rb") as f:
            (num_points,) = struct.unpack("<Q", f.read(8))
            for _ in range(num_points):
                data = struct.unpack("<Q3d3Bd", f.read(8 + 24 + 3 + 8))  # id, xyz, rgb, error
                xyzs.append(data[1:4])
                rgbs.append(data[4:7])
                (track_len,) = struct.unpack("<Q", f.read(8))
                f.seek(8 * track_len, 1)
    elif txt_path.exists():
        for line in txt_path.read_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            xyzs.append([float(v) for v in parts[1:4]])
            rgbs.append([int(v) for v in parts[4:7]])
    else:
        raise FileNotFoundError(f"no points3D.bin/.txt under {recon_dir}")
    return np.asarray(xyzs, np.float64), np.asarray(rgbs, np.uint8)


def create_ply_from_colmap(recon_dir, out_path, applied_transform=None):
    """Convert a colmap sparse model to a binary PLY point cloud, applying the
    dataset's `applied_transform` (colmap world -> transforms.json world), as
    nerfstudio's create_ply_from_colmap does (ref: freegaussian_dataparser.py:1010-1062)."""
    xyz, rgb = read_colmap_points3d(recon_dir)
    if applied_transform is not None:
        t = np.asarray(applied_transform, np.float64)
        xyz = xyz @ t[:3, :3].T + t[:3, 3]
    write_ply_points(out_path, xyz.astype(np.float32), rgb)
    return out_path
