"""Bilateral guided grid for per-image appearance correction (twin of
`freegaussian_tpu/models/bilagrid.py`, the reference's `use_bilateral_grid`):
each training image owns a (W, Y, X) grid of 3x4 affine color transforms;
the rendered image is sliced through its grid at (x / width, y / height,
luminance) with trilinear interpolation and transformed per pixel. Total
variation over the grids regularizes them.

The slice gathers the 8 corners of every pixel's cell, so the gradient of
the grid is a scatter-add (the indexing backward, `index_put_` with
accumulation), whose sums run in another order on the card than on the
CPU.
"""

from __future__ import annotations

import torch

from ..ops.math import device_constant, take_row

_LUMA = (0.299, 0.587, 0.114)


def init_bilateral_grids(
    num_images: int, grid_x: int = 16, grid_y: int = 16, grid_w: int = 8, device="cuda"
) -> torch.Tensor:
    """(num_images, grid_w, grid_y, grid_x, 12): identity affine transforms."""
    from ..device import resolve_device

    eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=1).reshape(12)
    return eye.expand(num_images, grid_w, grid_y, grid_x, 12).contiguous().to(resolve_device(device))


def _floor_frac(a: torch.Tensor, size: int):
    a0 = torch.clamp(torch.floor(a), 0, size - 1).long()
    a1 = torch.clamp(a0 + 1, max=size - 1)
    return a0, a1, a - a0


def slice_bilateral_grid(grids: torch.Tensor, image_idx, rgb: torch.Tensor) -> torch.Tensor:
    """Apply image_idx's grid to an (H, W, 3) rendered image."""
    grid = take_row(grids, image_idx)  # (W, Y, X, 12)
    gw, gy, gx, _ = grid.shape
    h, w = rgb.shape[:2]
    dev = rgb.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    u = (xs + 0.5) / w * (gx - 1)
    v = (ys + 0.5) / h * (gy - 1)
    luma = rgb @ device_constant(_LUMA, rgb.dtype, dev)
    # min(max(.)) splits the gradient in half at a guide of exactly 0 or 1,
    # as jnp.clip does (torch.clamp passes all of it)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    guide = torch.minimum(torch.maximum(luma, zero), one) * (gw - 1)

    u0, u1, fu = _floor_frac(u, gx)
    v0, v1, fv = _floor_frac(v, gy)
    g0, g1, fg = _floor_frac(guide, gw)

    def lerp(x, y, t):
        return x + (y - x) * t[..., None]

    c00 = lerp(grid[g0, v0, u0], grid[g0, v0, u1], fu)
    c10 = lerp(grid[g0, v1, u0], grid[g0, v1, u1], fu)
    c01 = lerp(grid[g1, v0, u0], grid[g1, v0, u1], fu)
    c11 = lerp(grid[g1, v1, u0], grid[g1, v1, u1], fu)
    c0 = lerp(c00, c10, fv)
    c1 = lerp(c01, c11, fv)
    affine = lerp(c0, c1, fg).reshape(h, w, 3, 4)

    rgb_h = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
    return torch.einsum("hwij,hwj->hwi", affine, rgb_h)


def total_variation_loss(grids: torch.Tensor) -> torch.Tensor:
    """Mean squared difference between neighboring grid cells on all 3 axes."""
    tv = torch.zeros((), device=grids.device)
    for axis in (1, 2, 3):
        d = torch.diff(grids, dim=axis)
        tv = tv + torch.mean(d * d)
    return tv
