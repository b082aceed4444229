"""Dataparsers (twin of `freegaussian_tpu/data/dataparsers.py`) for the four
dataset families the reference supports (freegaussian_dataparser.py):

  - D-NeRF / Blender       (`transforms_{split}.json` with per-frame `time`)
  - LiveScene synthetic    (blender-style `transforms.json` + depth/ +
                            interflow_n{k}/ + mask/, ref :1117-1288)
  - LiveScene real capture (nerfstudio `transforms.json`, auto-orient/center +
                            auto-scale, times from filename, flow_n{k}/,
                            masks/{fid}.npy, Brown distortion, ref :681-1114)
  - CoNeRF captures        (`dataset.json` + per-frame `camera/*.json` +
                            `rgb/{d}x/` pyramid + annotations, ref :289-678)

Host-side numpy code that runs once at startup and returns a ParsedDataset
of struct-of-array cameras and file lists; the datamanager loads the files
(and undistorts the real captures' frames). Image sizes come from the
files' headers (`data/images.py`: PNG by the port's decoder, JPEG by
Pillow; the GPU machine has no imageio).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .images import image_size
from .ply import create_ply_from_colmap, read_ply_points

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


def _attribute_valids(atrb_masks: np.ndarray) -> np.ndarray:
    """(N, M+1) validity of (N, H, W, M+1) masks: a channel is valid when it
    is empty or covers more than H*W/300 pixels (ref: :1092-1114)."""
    hh, ww = atrb_masks.shape[1:3]
    sums = atrb_masks.sum(axis=(1, 2))
    return (sums == 0) | (sums > hh * ww / 300)


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
    h, w = image_size(image_filenames[0])
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

    h, w = image_size(image_filenames[0])
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
        mask_valids = _attribute_valids(stacked)
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


# -----------------------------------------------------------------------------
# LiveScene real capture (ref: freegaussian_dataparser.py:681-1114)
# -----------------------------------------------------------------------------


def parse_real(
    data: Path,
    split: str = "train",
    *,
    interval: int = 2,
    load_flow: bool = True,
    load_mask: bool = True,
    train_split_fraction: float = 0.9,
    orientation_method: str = "up",
    center_method: str = "poses",
    auto_scale: bool = True,
    scale_factor: float = 1.0,
    downscale_factor: int = 1,
) -> ParsedDataset:
    data = Path(data)
    meta = json.loads((data / "transforms.json").read_text())
    frames = sorted(meta["frames"], key=lambda f: f["file_path"])

    def frame_intrinsic(f, key):  # per-frame intrinsics, else the meta's
        return float(f.get(key, meta.get(key, 0.0)))

    image_filenames, fg_mask_filenames, poses = [], [], []
    fx, fy, cx, cy, distort = [], [], [], [], []
    for f in frames:
        p = f["file_path"]
        if downscale_factor > 1:
            p = str(Path(p).parent / f"images_{downscale_factor}" / Path(p).name)
        image_filenames.append(data / p)
        # foreground loss mask (nerfstudio per-frame `mask_path`): feeds
        # batch["mask"], the masked L1+SSIM branch (ref freegaussian_model.py:948-957)
        fg_mask_filenames.append(data / f["mask_path"] if "mask_path" in f else None)
        poses.append(np.array(f["transform_matrix"], np.float32))
        fx.append(frame_intrinsic(f, "fl_x") / downscale_factor)
        fy.append(frame_intrinsic(f, "fl_y") / downscale_factor)
        cx.append(frame_intrinsic(f, "cx") / downscale_factor)
        cy.append(frame_intrinsic(f, "cy") / downscale_factor)
        distort.append([frame_intrinsic(f, k) for k in ("k1", "k2", "k3", "k4", "p1", "p2")])

    poses, transform = auto_orient_and_center_poses(np.stack(poses), method=orientation_method, center_method=center_method)
    scale = scale_factor
    if auto_scale:
        scale *= auto_scale_poses(poses)
    poses[:, :3, 3] *= scale

    n = len(frames)
    prev = _prev_ids(n, interval)
    poses0 = poses[prev].copy()

    # times from the filename's numeric suffix (ref :942-944)
    fids = [Path(p).stem.split("_")[-1] for p in image_filenames]
    try:
        fid_ints = [int(fid) for fid in fids]
        max_fid = max(max(fid_ints), 1)
        times = np.array([i / max_fid for i in fid_ints], np.float32)
    except ValueError:
        times = np.linspace(0, 1, n, dtype=np.float32)

    flow_filenames = [data / f"flow_n{interval}" / (Path(p).stem + ".npy") for p in image_filenames]
    mask_paths = [data / "masks" / f"{fid}.npy" for fid in fids]

    i_train, i_eval = train_eval_split_fraction(n, train_split_fraction)
    indices = i_train if split == "train" else i_eval
    sel = lambda lst: [lst[i] for i in indices]
    image_filenames = sel(image_filenames)
    h, w = image_size(image_filenames[0])

    atrb_masks = mask_valids = None
    if load_mask and mask_paths and Path(mask_paths[indices[0]]).exists():
        stacked = np.stack([np.load(mask_paths[i]) for i in indices])
        mask_valids = _attribute_valids(stacked)
        atrb_masks = stacked.astype(bool)

    seed = None
    ply = data / meta.get("ply_file_path", "sparse_pc.ply")
    if not ply.exists():
        # a colmap-processed dataset without its point cloud: convert
        # points3D.bin -> sparse_pc.ply once, applying applied_transform
        # (ref: freegaussian_dataparser.py:1010-1062; no prompt, as in the JAX package)
        colmap_dir = data / "colmap" / "sparse" / "0"
        if colmap_dir.exists():
            ply = data / "sparse_pc.ply"
            create_ply_from_colmap(colmap_dir, ply, meta.get("applied_transform"))
    if ply.exists():
        xyz, rgb = read_ply_points(ply)
        xyz = (np.einsum("ij,nj->ni", transform[:3, :3], xyz) + transform[:3, 3]) * scale
        seed = (xyz.astype(np.float32), rgb)

    return ParsedDataset(
        c2w=poses[indices][:, :3, :4],
        c2w0=poses0[indices][:, :3, :4],
        fx=np.array(fx, np.float32)[indices],
        fy=np.array(fy, np.float32)[indices],
        cx=np.array(cx, np.float32)[indices],
        cy=np.array(cy, np.float32)[indices],
        width=w,
        height=h,
        times=times[indices],
        times0=times[prev][indices],
        image_filenames=image_filenames,
        flow_filenames=sel(flow_filenames) if load_flow else None,
        mask_filenames=sel(fg_mask_filenames) if any(m is not None for m in fg_mask_filenames) else None,
        atrb_masks=atrb_masks,
        mask_valids=mask_valids,
        seed_points=seed,
        dataparser_scale=scale,
        dataparser_transform=transform,
        distortion=np.array(distort, np.float32)[indices],
    )


# -----------------------------------------------------------------------------
# CoNeRF captures (ref: freegaussian_dataparser.py:289-678)
# -----------------------------------------------------------------------------


def _conerf_camera_to_opengl(cam_json: dict, scale: float, downscale: int):
    """CoNeRF camera/*.json -> OpenGL c2w + pinhole intrinsics.

    CoNeRF stores the world-to-camera orientation and the camera position
    in OpenCV axes (look +z): flip the y and z columns for OpenGL
    (ref: freegaussian_dataparser.py:624-637)."""
    orientation = np.array(cam_json["orientation"], np.float32)  # (3, 3) w2c rotation
    position = np.array(cam_json["position"], np.float32)
    focal = float(cam_json["focal_length"]) / downscale
    pp = np.array(cam_json["principal_point"], np.float32) / downscale
    R_c2w = orientation.T
    R_c2w[:, 1:3] *= -1  # OpenCV -> OpenGL
    c2w = np.concatenate([R_c2w, position[:, None] * scale], axis=-1)
    return c2w.astype(np.float32), focal, pp


def parse_conerf(
    data: Path,
    split: str = "train",
    *,
    interval: int = 1,
    downscale: int = 2,
    load_mask: bool = True,
    scene_scale: float = 1.0,
    downscale_factor: int = 1,
) -> ParsedDataset:
    """`downscale` picks the rgb/{d}x pyramid level. `downscale_factor` is
    the reference's own dataparser field, which four shipped scene configs
    set to 1 (configs/conerf/{blender,metronome,transformer,two-metronomes}.yaml);
    the JAX package's parser has no such argument and refuses them. The
    port takes 1 (no further downscale) and refuses any other value."""
    from . import conerf_annotations as ann

    if downscale_factor != 1:
        raise ValueError(f"parse_conerf: downscale_factor {downscale_factor} is not supported; set `downscale` "
                         "(the rgb/{d}x pyramid level)")
    data = Path(data)
    dataset = json.loads((data / "dataset.json").read_text())
    ids = dataset["train_ids"] if split == "train" else dataset["val_ids"]
    all_ids = dataset["ids"]

    scene = {}
    if (data / "scene.json").exists():
        scene = json.loads((data / "scene.json").read_text())
    scale = float(scene.get("scale", 1.0)) * scene_scale

    def load_cam(fid):
        return _conerf_camera_to_opengl(json.loads((data / "camera" / f"{fid}.json").read_text()), scale, downscale)

    # cameras0 pairs with frame `idx - interval` of the FULL capture (by its
    # own camera json), not with the previous frame of the split (ref :489-512)
    id_to_idx = {fid: i for i, fid in enumerate(all_ids)}
    cams, focals, pps, cams0, image_filenames, prev_idxs = [], [], [], [], [], []
    cam_cache = {}
    for fid in ids:
        c2w, focal, pp = load_cam(fid)
        cams.append(c2w)
        focals.append(focal)
        pps.append(pp)
        image_filenames.append(data / "rgb" / f"{downscale}x" / f"{fid}.png")
        prev_idx = max(id_to_idx[fid] - interval, 0)
        prev_idxs.append(prev_idx)
        prev_fid = all_ids[prev_idx]
        if prev_fid not in cam_cache:
            cam_cache[prev_fid] = load_cam(prev_fid)[0]
        cams0.append(cam_cache[prev_fid])

    # times from the frame index over the full capture (ref :485-487); times0
    # is the paired frame's own time (ref :489-512)
    max_idx = max(len(all_ids) - 1, 1)
    times = np.array([id_to_idx[fid] / max_idx for fid in ids], np.float32)
    times0 = np.array([i / max_idx for i in prev_idxs], np.float32)

    h, w = image_size(image_filenames[0])

    seed = None
    if (data / "points.ply").exists():
        xyz, rgb = read_ply_points(data / "points.ply")
        xyz = (xyz - np.array(scene.get("center", [0, 0, 0]), np.float32)) * scale
        seed = (xyz.astype(np.float32), rgb)

    # hand-annotated articulation masks and per-frame attribute values
    # (ref: freegaussian_dataparser.py:156-286), by three routes in order
    atrb_masks = mask_valids = None
    coco_json = data / "annotations.coco.json"
    if load_mask and coco_json.exists():
        # one COCO json over the capture (dmode="coco", ref :309, :564-566)
        m = ann.coco_num_attributes(coco_json)
        per_stem = ann.load_coco_annotations(coco_json, h, w, m, downscale)
        atrb_masks = np.stack([per_stem.get(str(fid), np.zeros((h, w, m + 1), bool)) for fid in ids])
        mask_valids = _attribute_valids(atrb_masks)
    elif load_mask and (data / "annotations").exists():
        ann_dir = data / "annotations"
        m = ann.discover_num_attributes(data)
        if any(ann_dir.glob("*_segmentation.npy")):
            # blender-exported segmentation arrays (ref :241-265)
            atrb_masks, mask_valids = ann.load_blender_annotations(ann_dir, ids, h, w, max(m, 1))
        elif m > 0:
            masks = []
            for fid in ids:
                mk = ann.load_conerf_annotation(ann_dir / f"{fid}.json", h, w, m, downscale)
                masks.append(mk if mk is not None else np.zeros((h, w, m + 1), bool))
            atrb_masks = np.stack(masks)
            mask_valids = _attribute_valids(atrb_masks)

    # scene box from scene.json's bbox, in OpenGL axes (ref :454-470)
    scene_box = None
    if "bbox" in scene:
        aabb = (np.asarray(scene["bbox"], np.float32) - np.asarray(scene.get("center", [0, 0, 0]), np.float32)[None]) * scale
        aabb = aabb[:, [0, 2, 1]]
        aabb[:, 2] *= -1
        scene_box = np.sort(aabb, axis=0)

    # per-frame scalar attribute values (ref :268-286 load_conerf_values)
    atrb_values = atrb_val_masks = None
    m_attrs = atrb_masks.shape[-1] - 1 if atrb_masks is not None else 0
    for cand in (data / "annotations" / "values.yaml", data / "values.yaml"):
        if cand.exists():
            atrb_values, atrb_val_masks = ann.load_conerf_values_yaml(cand, [int(str(fid)) for fid in ids], max(m_attrs, 1))
            break

    return ParsedDataset(
        c2w=np.stack(cams),
        c2w0=np.stack(cams0),
        fx=np.array(focals, np.float32),
        fy=np.array(focals, np.float32),
        cx=np.array([p[0] for p in pps], np.float32),
        cy=np.array([p[1] for p in pps], np.float32),
        width=w,
        height=h,
        times=times,
        times0=times0,
        image_filenames=image_filenames,
        atrb_masks=atrb_masks,
        mask_valids=mask_valids,
        seed_points=seed,
        dataparser_scale=scale,
        scene_box=scene_box,
        atrb_values=atrb_values,
        atrb_val_masks=atrb_val_masks,
    )


PARSERS = {
    "dnerf": parse_dnerf,
    "synthetic": parse_synthetic,
    "real": parse_real,
    "conerf": parse_conerf,
}
