"""Epipolar interflow (twin of `freegaussian_tpu/preprocess/epipolar_flow.py`):
separate the flow the camera's own motion induces (sceneflow) from the
objects' motion, for the flow-derivative losses.

Two forms, as in the reference preprocess:

1. Velocity-Jacobian form (preprocess/epipolar_flow.py:233-321): per-pixel
   2x3 Jacobians A(x, y) (translational, depth-weighted) and B(x, y)
   (rotational) of projected flow w.r.t. the camera twist (v, omega):
       sceneflow = A v / Z + B omega
       interflow = opticalflow + sceneflow
   with omega = euler(R1^-1 R2), v = t2 - t1 of the OpenCV-converted c2w
   pair, and infinite-depth pixels zeroed.

2. Exact backprojection form (preprocess/epipolar_flow_bp.py:258-298):
   backproject pixels through depth with camera0, reproject into camera1:
       sceneflow = uv' - uv;  interflow = opticalflow - sceneflow

Optical flow itself is an external plug-in (the reference runs RAFT/GMA via
mmflow): precomputed flow `.npy` maps are read (epipolar_flow.py:369-372).
The maps are computed in float32 on the caller's device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.cameras import Camera
from ..ops.math import euler_xyz_from_matrix, opengl_to_opencv_c2w, to_4x4


def _pixel_centres(h: int, w: int, device) -> tuple:
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float32) + 0.5,
        torch.arange(w, device=device, dtype=torch.float32) + 0.5,
        indexing="ij",
    )
    return xs, ys


def pixel_jacobians(camera: Camera):
    """A (H, W, 2, 3) translational and B (H, W, 2, 3) rotational Jacobians of
    projected pixel motion w.r.t. the camera twist (ref: epipolar_flow.py:274-305)."""
    h, w = camera.height, camera.width
    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    x, y = _pixel_centres(h, w, camera.fx.device)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    A = torch.stack([one * fx, zero, cx - x, zero, one * fy, cy - y], dim=-1).reshape(h, w, 2, 3)
    B = torch.stack(
        [
            -(x - cx) * (y - cy) / fy,
            fx + (x - cx) ** 2 / fx,
            -(y - cy) * fx / fy,
            -fy - (y - cy) ** 2 / fy,
            (x - cx) * (y - cy) / fx,
            (x - cx) * fy / fx,
        ],
        dim=-1,
    ).reshape(h, w, 2, 3)
    return A, B


def _masked(Z: torch.Tensor, sceneflow: torch.Tensor, interflow: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero both maps where the depth is infinite or not positive."""
    bad = (torch.isinf(Z[..., 0]) | (Z[..., 0] <= 0))[..., None]
    return {"sceneflow": torch.where(bad, 0.0, sceneflow), "interflow": torch.where(bad, 0.0, interflow)}


def diff_2d_epipolar_flow(Z: torch.Tensor, camera0: Camera, camera1: Camera, opticalflow: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Velocity-Jacobian interflow (ref: epipolar_flow.py:233-321). Z (H, W, 1)
    is the current frame's depth, opticalflow (H, W, 2)."""
    c2w0 = opengl_to_opencv_c2w(to_4x4(camera0.c2w))
    c2w1 = opengl_to_opencv_c2w(to_4x4(camera1.c2w))
    omega = euler_xyz_from_matrix(c2w0[:3, :3].T @ c2w1[:3, :3])
    veloc = c2w1[:3, 3] - c2w0[:3, 3]
    A, B = pixel_jacobians(camera0)
    sceneflow = (A @ veloc) / Z + (B @ omega)
    return _masked(Z, sceneflow, opticalflow + sceneflow)


def diff_2d_epipolar_flow_backproject(
    Z0: torch.Tensor, camera0: Camera, camera1: Camera, opticalflow: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Exact backprojection interflow (ref: epipolar_flow_bp.py:258-298):
    sceneflow = reproject(backproject(uv, Z0, cam0), cam1) - uv. Z0 (H, W, 1)
    is frame 0's depth, opticalflow (H, W, 2) frame 0 -> frame 1."""
    h, w = Z0.shape[:2]
    c2w0 = to_4x4(opengl_to_opencv_c2w(to_4x4(camera0.c2w)))
    c2w1 = to_4x4(opengl_to_opencv_c2w(to_4x4(camera1.c2w)))
    xs, ys = _pixel_centres(h, w, Z0.device)
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
    rays = pix @ torch.linalg.inv(camera0.K).T
    p_world = (rays * Z0) @ c2w0[:3, :3].T + c2w0[:3, 3]
    w2c1 = torch.linalg.inv(c2w1)
    uv1 = (p_world @ w2c1[:3, :3].T + w2c1[:3, 3]) @ camera1.K.T
    uv1 = uv1[..., :2] / torch.clamp(uv1[..., 2:3], min=1e-8)
    sceneflow = uv1 - pix[..., :2]
    return _masked(Z0, sceneflow, opticalflow - sceneflow)


def generate_interflow_dataset(
    data_dir: Path,
    *,
    interval: int = 2,
    form: str = "velocity",
    flow_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    split: str = "train",
    dataparser: str = "synthetic",
    device="cuda",
) -> int:
    """Compute the interflow of every frame pair (i - interval, i) and write
    interflow_n{interval}/*.npy (synthetic) or flow_n{interval}/ (real
    captures: the directory their parser reads), float32 (H, W, 2)
    (ref: epipolar_flow.py:324-420; real-scene flow_n{k} at
    freegaussian_dataparser.py:816). Reads the optical flow from
    `opticalflow/{stem}.npy` (or `flow_dir`), zero flow where a frame has
    none (static-camera captures), and needs depth/{stem}.npy renders
    (`render` verb). Returns the number of maps written."""
    from ..data.dataparsers import parse_real, parse_synthetic
    from ..device import resolve_device

    dev = resolve_device(device)
    data_dir = Path(data_dir)
    if dataparser == "synthetic":
        parsed = parse_synthetic(data_dir, split, interval=interval, load_flow=False, load_mask=False, train_split_fraction=1.0)
        default_out = f"interflow_n{interval}"
    elif dataparser == "real":
        parsed = parse_real(data_dir, split, interval=interval, load_flow=False, load_mask=False, train_split_fraction=1.0)
        default_out = f"flow_n{interval}"
    else:
        raise ValueError(f"interflow supports synthetic|real, got {dataparser}")
    out = data_dir / (out_dir or default_out)
    out.mkdir(exist_ok=True, parents=True)
    flow_src = data_dir / (flow_dir or "opticalflow")
    fn = diff_2d_epipolar_flow if form == "velocity" else diff_2d_epipolar_flow_backproject

    def tensor(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    count = 0
    for i in range(len(parsed)):
        stem = Path(parsed.image_filenames[i]).stem
        if parsed.depth_filenames is not None:
            depth_path = Path(parsed.depth_filenames[i])
        else:
            depth_path = data_dir / "depth" / (stem + ".npy")
        if not depth_path.exists():
            raise FileNotFoundError(f"missing depth render {depth_path}; run the depth preprocess (render_offline) first")
        depth = np.load(depth_path).astype(np.float32)
        if depth.ndim == 2:
            depth = depth[..., None]
        flow_path = flow_src / f"{stem}.npy"
        if flow_path.exists():
            oflow = np.load(flow_path).astype(np.float32)
        else:
            oflow = np.zeros((parsed.height, parsed.width, 2), np.float32)

        def cam(c2w):
            return Camera(
                c2w=tensor(c2w), fx=tensor(parsed.fx[i]), fy=tensor(parsed.fy[i]), cx=tensor(parsed.cx[i]),
                cy=tensor(parsed.cy[i]), time=tensor(parsed.times[i]), width=parsed.width, height=parsed.height,
            )

        result = fn(tensor(depth), cam(parsed.c2w0[i]), cam(parsed.c2w[i]), tensor(oflow))
        np.save(out / f"{stem}.npy", result["interflow"].cpu().numpy())
        count += 1
    return count
