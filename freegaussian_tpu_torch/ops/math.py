"""Core math ops: quaternions, positional embedding, viewmat convention.

Torch twins of `freegaussian_tpu/ops/math.py` (same formulas, same band and
axis orders) for the functions the serving path needs.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False, eps: float = 1e-24) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices (normalizes first)."""
    quat = quat / safe_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quats_to_covar(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """3D covariance R S S^T R^T from linear-space scales + quats."""
    L = quat_to_rotmat(quats) * scales[..., None, :]
    return L @ L.transpose(-1, -2)


def positional_embed(x: torch.Tensor, num_freqs: int, include_input: bool = True) -> torch.Tensor:
    """NeRF encoding with frequencies 2^0 .. 2^(L-1), band order
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    freqs = torch.tensor([2.0**i for i in range(num_freqs)], dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]  # (..., L, d)
    sc = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)  # (..., L, 2, d)
    sc = sc.reshape(*lead, 2 * num_freqs * d)
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc


def get_viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """OpenGL camera-to-world (..., 3|4, 4) -> OpenCV world-to-camera (..., 4, 4)."""
    R = c2w[..., :3, :3]
    T = c2w[..., :3, 3:4]
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=c2w.dtype, device=c2w.device)
    R = R * flip[None, :]
    R_inv = R.transpose(-1, -2)
    T_inv = -(R_inv @ T)
    top = torch.cat([R_inv, T_inv], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2
