"""Flow-derivative losses (twin of `freegaussian_tpu/ops/flow.py`).

- `query_3d_gaussian_flow`: advect each projected Gaussian center through
  interflow, sample the paired frame's depth there, and backproject through
  K^-1 and the paired camera's OpenCV c2w: a per-Gaussian 3D target for the
  deformation field at the paired time.
- `flow_supervision_loss`: L1 between the deformed means at the paired time
  and those targets, over visible live Gaussians.
- `rendered_flow_loss`: alpha-weighted L1 between the composited
  screen-space motion and the negated interflow.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .math import bilinear_interp


def query_3d_gaussian_flow(
    means2d: torch.Tensor,  # (N, 2) projected centers in the current camera
    Z0: torch.Tensor,  # (H, W, 1) depth map of the paired camera
    interflow: torch.Tensor,  # (H, W, 2) object-motion flow current -> paired
    c2w_prev: torch.Tensor,  # (3|4, 4) paired camera OpenCV c2w
    K: torch.Tensor,  # (3, 3)
    *,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Returns {"p_world": (N, 3), "valid": (N,)}, zeros for off-screen or
    invalid Gaussians."""
    h, w = Z0.shape[:2]
    x, y = means2d[:, 0], means2d[:, 1]
    inb = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    if valid is not None:
        inb = inb & valid
    xs = torch.where(inb, x, torch.zeros_like(x))
    ys = torch.where(inb, y, torch.zeros_like(y))

    flow = bilinear_interp(interflow[None], xs[None], ys[None])[0]  # (N, 2)
    x2 = xs + flow[:, 0]
    y2 = ys + flow[:, 1]
    Z = bilinear_interp(Z0[None], x2[None], y2[None])[0, :, 0]  # (N,)

    Kinv = torch.linalg.inv(K)
    pix_h = torch.stack([x2, y2, torch.ones_like(x2)], dim=-1)  # (N, 3)
    p_cam = (pix_h @ Kinv.T) * Z[:, None]
    R = c2w_prev[:3, :3]
    t = c2w_prev[:3, 3]
    p_world = p_cam @ R.T + t
    p_world = torch.where(inb[:, None], p_world, torch.zeros_like(p_world))
    return {"p_world": p_world, "valid": inb}


def flow_supervision_loss(
    means_deformed_prev: torch.Tensor,  # (N, 3) deform-field output at the paired time
    lifted: Dict[str, torch.Tensor],
    radii: torch.Tensor,
    *,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    mask = lifted["valid"] & (radii > 0)
    if alive is not None:
        mask = mask & alive
    diff = torch.abs(means_deformed_prev - lifted["p_world"].detach())
    per_g = torch.sum(diff, dim=-1)
    denom = torch.clamp(mask.sum(), min=1)
    return torch.sum(torch.where(mask, per_g, torch.zeros_like(per_g))) / denom


def rendered_flow_loss(
    rendered_flow: torch.Tensor,  # (H, W, 2) composited screen-space motion
    interflow: torch.Tensor,  # (H, W, 2) target
    alpha: torch.Tensor,  # (H, W, 1)
) -> torch.Tensor:
    """interflow points current -> paired while the rendered motion is
    paired -> current, so the target is negated."""
    w = alpha.detach()
    return torch.sum(w * torch.abs(rendered_flow - (-interflow))) / torch.clamp(torch.sum(w) * 2.0, min=1.0)
