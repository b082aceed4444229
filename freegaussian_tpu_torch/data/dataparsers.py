"""Dataparsers (twin of `freegaussian_tpu/data/dataparsers.py`) for the
families the port trains on so far:

  - D-NeRF / Blender       (`transforms_{split}.json` with per-frame `time`)
  - LiveScene synthetic    (blender-style `transforms.json` + depth/ +
                            interflow_n{k}/ + mask/, ref :1117-1288)

Host-side numpy code that runs once at startup and returns a ParsedDataset
of struct-of-array cameras and file lists; the datamanager loads the files.
Images are PNGs read by `viewer/png.py` (the GPU machine has no imageio).
The real-capture and CoNeRF parsers need image undistortion and polygon
fill, and are not ported yet (ROADMAP.md): `parse_real` and `parse_conerf`
raise.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..viewer.png import read_png
from .ply import read_ply_points

# -----------------------------------------------------------------------------
# Pose utilities (nerfstudio camera_utils semantics)
# -----------------------------------------------------------------------------


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> Tuple[np.ndarray, np.ndarray]:
    """nerfstudio auto_orient_and_center_poses: align the mean up-vector with
    +z and center the translations. poses: (N, 4, 4) or (N, 3, 4) OpenGL
    c2w. Returns (oriented (N, 3, 4), transform (3, 4))."""
    poses = np.asarray(poses, np.float64)
    if poses.shape[-2] == 3:
        bottom = np.tile(np.array([0, 0, 0, 1.0]), (poses.shape[0], 1, 1))
        poses = np.concatenate([poses, bottom], axis=-2)
    origins = poses[:, :3, 3]
    if center_method in ("poses", "focus"):  # "focus" is simplified to "poses", as in the JAX package
        translation = origins.mean(axis=0)
    else:
        translation = np.zeros(3)
    if method == "up":
        rotation = rotation_matrix_between(poses[:, :3, 1].mean(axis=0), np.array([0, 0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unsupported orientation method {method}")
    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=-1)
    oriented = np.einsum("ij,njk->nik", transform[:3, :3], poses[:, :3, :4])
    oriented[:, :3, 3] += transform[:3, 3]
    return oriented.astype(np.float32), transform.astype(np.float32)


def auto_scale_poses(poses: np.ndarray) -> float:
    """nerfstudio auto_scale: 1 / max translation norm."""
    return float(1.0 / max(np.max(np.abs(poses[:, :3, 3])), 1e-8))


def train_eval_split_fraction(n: int, fraction: float) -> Tuple[np.ndarray, np.ndarray]:
    num_train = math.ceil(n * fraction)
    i_train = np.linspace(0, n - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(n), i_train)
    return i_train, i_eval


# -----------------------------------------------------------------------------
# Output container
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class ParsedDataset:
    """Struct-of-arrays camera set + per-frame file pointers."""

    c2w: np.ndarray  # (N, 3, 4) oriented OpenGL camera-to-world
    c2w0: np.ndarray  # (N, 3, 4) previous-frame cameras (`cameras0`)
    fx: np.ndarray  # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    times: np.ndarray  # (N,)
    image_filenames: List[Path]
    times0: Optional[np.ndarray] = None  # (N,) paired-frame (`cameras0`) times
    flow_filenames: Optional[List[Path]] = None
    depth_filenames: Optional[List[Path]] = None
    depth0_filenames: Optional[List[Path]] = None  # paired (prev) frame depth
    mask_filenames: Optional[List[Path]] = None
    atrb_masks: Optional[np.ndarray] = None  # (N, H, W, M+1) bool
    mask_valids: Optional[np.ndarray] = None  # (N, M+1) bool
    seed_points: Optional[Tuple[np.ndarray, np.ndarray]] = None
    dataparser_scale: float = 1.0
    dataparser_transform: Optional[np.ndarray] = None
    distortion: Optional[np.ndarray] = None  # (N, 6) k1 k2 k3 k4 p1 p2
    scene_box: Optional[np.ndarray] = None  # (2, 3) axis-aligned aabb (OpenGL)
    atrb_values: Optional[np.ndarray] = None  # (N, M+1) per-frame attribute states
    atrb_val_masks: Optional[np.ndarray] = None  # (N, M+1) validity of values

    def __len__(self) -> int:
        return len(self.image_filenames)


def _prev_ids(n: int, interval: int) -> np.ndarray:
    return np.maximum(np.arange(n) - interval, 0)


def _image_size(path: Path) -> Tuple[int, int]:
    """(height, width) of an image file."""
    h, w = read_png(path).shape[:2]
    return h, w


# -----------------------------------------------------------------------------
# D-NeRF / Blender (ref: freegaussian_dataparser.py:52-150)
# -----------------------------------------------------------------------------


def parse_dnerf(
    data: Path,
    split: str = "train",
    *,
    interval: int = 1,
    ply_path: Optional[Path] = None,
) -> ParsedDataset:
    data = Path(data)
    split_name = {"train": "train", "val": "val", "test": "test"}[split]
    meta = json.loads((data / f"transforms_{split_name}.json").read_text())
    frames = meta["frames"]
    poses = np.array([f["transform_matrix"] for f in frames], np.float32)
    times = np.array(
        [f.get("time", i / max(len(frames) - 1, 1)) for i, f in enumerate(frames)],
        np.float32,
    )
    image_filenames = [data / (f["file_path"].replace("./", "") + ".png") for f in frames]
    h, w = _image_size(image_filenames[0])
    focal = 0.5 * w / math.tan(0.5 * float(meta["camera_angle_x"]))
    n = len(frames)
    prev = _prev_ids(n, interval)
    seed = None
    if ply_path is not None and Path(ply_path).exists():
        seed = read_ply_points(ply_path)
    return ParsedDataset(
        c2w=poses[:, :3, :4],
        c2w0=poses[prev][:, :3, :4],
        fx=np.full(n, focal, np.float32),
        fy=np.full(n, focal, np.float32),
        cx=np.full(n, w / 2.0, np.float32),
        cy=np.full(n, h / 2.0, np.float32),
        width=w,
        height=h,
        times=times,
        times0=times[prev],
        image_filenames=image_filenames,
        seed_points=seed,
    )


# -----------------------------------------------------------------------------
# LiveScene synthetic / OmniGibson (ref: freegaussian_dataparser.py:1117-1288)
# -----------------------------------------------------------------------------


def parse_synthetic(
    data: Path,
    split: str = "train",
    *,
    interval: int = 2,
    load_flow: bool = True,
    load_mask: bool = True,
    train_split_fraction: float = 0.9,
    orientation_method: str = "up",
    center_method: str = "poses",
    scale_factor: float = 1.0,
) -> ParsedDataset:
    data = Path(data)
    meta = json.loads((data / "transforms.json").read_text())
    frames = meta["frames"]
    image_filenames = [data / (f["file_path"].replace("./", "") + ".png") for f in frames]
    depth_filenames = [data / (f["file_path"].replace("./images", "depth") + ".npy") for f in frames]
    flow_filenames = [
        data / (f["file_path"].replace("./images", f"interflow_n{interval}") + ".npy") for f in frames
    ]
    poses = np.array([f["transform_matrix"] for f in frames], np.float32)
    poses, transform = auto_orient_and_center_poses(poses, method=orientation_method, center_method=center_method)
    poses[:, :3, 3] *= scale_factor
    n = len(frames)
    prev = _prev_ids(n, interval)
    poses0 = poses[prev].copy()

    i_train, i_eval = train_eval_split_fraction(n, train_split_fraction)
    indices = i_train if split == "train" else i_eval
    sel = lambda lst: [lst[i] for i in indices]

    depth0_filenames = sel([depth_filenames[j] for j in prev])
    image_filenames = sel(image_filenames)
    depth_filenames = sel(depth_filenames)
    flow_filenames = sel(flow_filenames)
    poses_s = poses[indices]
    poses0_s = poses0[indices]

    h, w = _image_size(image_filenames[0])
    focal = 0.5 * w / math.tan(0.5 * float(meta["camera_angle_x"]))

    # times over the FULL capture, then selected: `times0` pairs with frame
    # idx - interval of the full frame list (ref :489-512)
    fids_full = [Path(f["file_path"]).stem.split("_")[-1] for f in frames]
    max_fid = max(int(fid) for fid in fids_full)
    times_full = np.array([int(fid) / max(max_fid, 1) for fid in fids_full], np.float32)
    times = times_full[indices]
    times0 = times_full[prev][indices]
    fids = [fids_full[i] for i in indices]

    atrb_masks = mask_valids = None
    if load_mask:
        stacked = np.stack([np.load(data / "mask" / f"{fid}.npy") for fid in fids])
        hh, ww = stacked.shape[1:3]
        sums = stacked.sum(axis=(1, 2))
        mask_valids = (sums == 0) | (sums > hh * ww / 300)
        atrb_masks = stacked.astype(bool)

    nsel = len(indices)
    return ParsedDataset(
        c2w=poses_s[:, :3, :4],
        c2w0=poses0_s[:, :3, :4],
        fx=np.full(nsel, focal, np.float32),
        fy=np.full(nsel, focal, np.float32),
        cx=np.full(nsel, w / 2.0, np.float32),
        cy=np.full(nsel, h / 2.0, np.float32),
        width=w,
        height=h,
        times=times,
        times0=times0,
        image_filenames=image_filenames,
        depth_filenames=depth_filenames,
        depth0_filenames=depth0_filenames,
        flow_filenames=flow_filenames if load_flow else None,
        atrb_masks=atrb_masks,
        mask_valids=mask_valids,
        dataparser_scale=scale_factor,
        dataparser_transform=transform,
    )


def parse_real(data: Path, split: str = "train", **kwargs) -> ParsedDataset:
    """The LiveScene real-capture parser: not ported yet (it needs image
    undistortion; ROADMAP.md §A)."""
    raise NotImplementedError("parse_real (LiveScene real captures) is not ported yet: it needs undistortion (ROADMAP.md §A)")


def parse_conerf(data: Path, split: str = "train", **kwargs) -> ParsedDataset:
    """The CoNeRF parser: not ported yet (it needs undistortion and polygon
    fill for its annotations; ROADMAP.md §A)."""
    raise NotImplementedError(
        "parse_conerf (CoNeRF captures) is not ported yet: it needs undistortion and polygon fill (ROADMAP.md §A)"
    )


PARSERS = {
    "dnerf": parse_dnerf,
    "synthetic": parse_synthetic,
    "real": parse_real,
    "conerf": parse_conerf,
}
