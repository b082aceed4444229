"""EWA projection of 3D Gaussians to screen space.

Torch twin of `freegaussian_tpu/ops/projection.py:project_gaussians`
(gsplat `fully_fused_projection` contract: near=0.01, far=1e10, classic
+eps2d low-pass or antialiased compensation, int 3-sigma radii, zeroed
conics/compensations for culled Gaussians). Runs in full f32 with the same
channelized formulas, so results agree with the JAX package to f32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ProjectionResult(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixel coords
    depths: torch.Tensor  # (N,) camera-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # (N,) int32 screen radius, 0 for culled
    compensations: torch.Tensor  # (N,) antialiasing opacity compensation
    cov2d: torch.Tensor  # (N, 3) blurred 2D covariance (xx, xy, yy)
    means_cam: torch.Tensor  # (N, 3) camera-space means


def project_gaussians(
    means: torch.Tensor,  # (N, 3) world-space centers
    quats: torch.Tensor,  # (N, 4) wxyz (need not be normalized)
    scales: torch.Tensor,  # (N, 3) linear-space scales
    viewmat: torch.Tensor,  # (4, 4) world-to-camera (OpenCV convention)
    K: torch.Tensor,  # (3, 3) intrinsics
    width: int,
    height: int,
    *,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    eps2d: float = 0.3,
    radius_clip: float = 0.0,
    calc_compensations: bool = False,
    alive: torch.Tensor | None = None,  # (N,) bool mask for padded capacity
) -> ProjectionResult:
    """Project N 3D Gaussians into one camera. Culled Gaussians get radii == 0."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    p_cam = means @ R.T + t
    x, y, z = p_cam.unbind(-1)
    valid_z = (z > near_plane) & (z < far_plane)
    if alive is not None:
        valid_z = valid_z & alive
    one = torch.ones_like(z)
    zero = torch.zeros_like(z)
    z_safe = torch.where(valid_z, z, one)
    x = torch.where(valid_z, x, zero)
    y = torch.where(valid_z, y, zero)
    rz = 1.0 / z_safe

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    tx = z_safe * torch.clamp(x * rz, -lim_x_neg, lim_x_pos)
    ty = z_safe * torch.clamp(y * rz, -lim_y_neg, lim_y_pos)

    qn = quats / torch.sqrt(torch.sum(quats * quats, dim=-1) + 1e-24)[..., None]
    qw, qx, qy, qz = qn.unbind(-1)
    rq = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)),
        (2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)),
        (2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)),
    )
    # A = R_cam @ R_q, channelized (camera R entries are scalars)
    A = tuple(
        tuple(R[i, 0] * rq[0][k] + R[i, 1] * rq[1][k] + R[i, 2] * rq[2][k] for k in range(3))
        for i in range(3)
    )
    # B = J @ A, with J = [[fx rz, 0, -fx tx rz^2], [0, fy rz, -fy ty rz^2]]
    j02 = -fx * tx * rz * rz
    j12 = -fy * ty * rz * rz
    b0 = tuple(fx * rz * A[0][k] + j02 * A[2][k] for k in range(3))
    b1 = tuple(fy * rz * A[1][k] + j12 * A[2][k] for k in range(3))
    s0, s1, s2 = scales.unbind(-1)
    ss = (s0 * s0, s1 * s1, s2 * s2)
    cxx = b0[0] * b0[0] * ss[0] + b0[1] * b0[1] * ss[1] + b0[2] * b0[2] * ss[2]
    cxy = b0[0] * b1[0] * ss[0] + b0[1] * b1[1] * ss[1] + b0[2] * b1[2] * ss[2]
    cyy = b1[0] * b1[0] * ss[0] + b1[1] * b1[1] * ss[1] + b1[2] * b1[2] * ss[2]

    det_orig = cxx * cyy - cxy * cxy
    cxx_b = cxx + eps2d
    cyy_b = cyy + eps2d
    det_blur = cxx_b * cyy_b - cxy * cxy

    if calc_compensations:
        compensations = torch.sqrt(torch.clamp(det_orig / torch.clamp(det_blur, min=1e-32), min=0.0))
    else:
        compensations = torch.ones_like(det_blur)

    det_safe = torch.where(det_blur <= 0, one, det_blur)
    inv_det = 1.0 / det_safe
    conics = torch.stack([cyy_b * inv_det, -cxy * inv_det, cxx_b * inv_det], dim=-1)

    means2d = torch.stack([fx * x * rz + cx, fy * y * rz + cy], dim=-1)

    b = 0.5 * (cxx_b + cyy_b)
    v1 = b + torch.sqrt(torch.clamp(b * b - det_blur, min=0.01))
    radius_f = torch.ceil(3.0 * torch.sqrt(v1))

    valid = valid_z & (det_blur > 0) & (radius_f > radius_clip)
    valid = valid & (means2d[..., 0] + radius_f > 0) & (means2d[..., 0] - radius_f < width)
    valid = valid & (means2d[..., 1] + radius_f > 0) & (means2d[..., 1] - radius_f < height)
    if alive is not None:
        valid = valid & alive

    radii = torch.where(valid, radius_f, zero).to(torch.int32)
    conics = torch.where(valid[..., None], conics, torch.zeros_like(conics))
    compensations = torch.where(valid, compensations, torch.zeros_like(compensations))
    return ProjectionResult(
        means2d=means2d,
        depths=z,
        conics=conics,
        radii=radii,
        compensations=compensations,
        cov2d=torch.stack([cxx_b, cxy, cyy_b], dim=-1),
        means_cam=p_cam,
    )
