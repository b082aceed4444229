"""Camera-pose optimizer, SO3xR3 (twin of `freegaussian_tpu/models/camera_opt.py`,
nerfstudio's CameraOptimizer): one 6-vector tangent adjustment per training
camera, applied as a left-multiplied rotation and translation of the OpenGL
c2w, with nerfstudio's L2 regularization of the adjustments.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.cameras import Camera
from ..ops.math import exp_so3, safe_norm, take_row


def init_camera_opt(num_cameras: int, device="cuda") -> torch.Tensor:
    """(num_cameras, 6) zero tangent vectors (identity adjustment)."""
    from ..device import resolve_device

    return torch.zeros((num_cameras, 6), device=resolve_device(device))


def apply_camera_opt(adjustments: torch.Tensor, camera: Camera, cam_idx) -> Camera:
    """The camera with the cam_idx-th adjustment applied to its c2w. At a
    zero tangent the axis is 0 / safe_norm's eps (the identity rotation),
    and the gradient stays finite."""
    v = take_row(adjustments, cam_idx)
    phi, t = v[:3], v[3:]
    theta = safe_norm(phi, keepdim=True)
    axis = phi / theta
    R = exp_so3(axis[None], theta[None])[0]
    c2w = camera.c2w
    R_new = R @ c2w[:3, :3]
    t_new = R @ c2w[:3, 3] + t
    return dataclasses.replace(camera, c2w=torch.cat([R_new, t_new[:, None]], dim=-1))


def camera_opt_reg_loss(
    adjustments: torch.Tensor, *, trans_l2_penalty: float = 1e-2, rot_l2_penalty: float = 1e-3
) -> torch.Tensor:
    """nerfstudio's pose-adjustment L2 regularization."""
    rot = adjustments[..., :3]
    trans = adjustments[..., 3:]
    return trans_l2_penalty * torch.sum(trans**2) + rot_l2_penalty * torch.sum(rot**2)
