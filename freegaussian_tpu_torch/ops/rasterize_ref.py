"""Compositing constants, tile bounds and the dense reference rasterizer.

Torch twin of `freegaussian_tpu/ops/rasterize_ref.py`. The compositing
contract (gsplat `rasterize_to_pixels`):

  - per-pixel front-to-back alpha compositing in depth order
  - alpha = min(0.999, opacity * exp(-sigma)), sigma from the conic
  - skip if sigma < 0 or alpha < 1/255
  - terminate the pixel when the *next* transmittance would drop <= 1e-4
    (the terminating Gaussian itself is not composited)
  - a Gaussian only contributes to pixels of tiles its radius bbox overlaps

`rasterize_pixels_reference` is the dense (pixels x Gaussians) oracle the
tests hold the tile path against; the serving path never calls it.
"""

from __future__ import annotations

import torch

ALPHA_THRESHOLD = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
MAX_ALPHA = 0.999


def depth_sort_order(depths: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """Depth-ascending order with culled Gaussians (radii == 0) pushed to the end."""
    key = torch.where(radii > 0, depths, torch.full_like(depths, float("inf")))
    return torch.argsort(key, stable=True)


def tile_bounds(means2d: torch.Tensor, radii: torch.Tensor, tile_size: int, tiles_w: int, tiles_h: int):
    """Inclusive-exclusive tile ranges each Gaussian overlaps (gsplat isect_tiles)."""
    r = radii.to(means2d.dtype)
    mx, my = means2d[..., 0], means2d[..., 1]
    tmin_x = torch.clamp(torch.floor((mx - r) / tile_size), 0, tiles_w).to(torch.int32)
    tmax_x = torch.clamp(torch.ceil((mx + r) / tile_size), 0, tiles_w).to(torch.int32)
    tmin_y = torch.clamp(torch.floor((my - r) / tile_size), 0, tiles_h).to(torch.int32)
    tmax_y = torch.clamp(torch.ceil((my + r) / tile_size), 0, tiles_h).to(torch.int32)
    return tmin_x, tmax_x, tmin_y, tmax_y


def rasterize_pixels_reference(
    means2d: torch.Tensor,  # (N, 2)
    conics: torch.Tensor,  # (N, 3)
    colors: torch.Tensor,  # (N, C)
    opacities: torch.Tensor,  # (N,)
    depths: torch.Tensor,  # (N,) sort key (camera z)
    radii: torch.Tensor,  # (N,); 0 == culled
    width: int,
    height: int,
    tile_size: int = 16,
    pixel_chunk: int = 4096,
):
    """Returns (render (H, W, C), alpha (H, W, 1), final_T (H, W))."""
    dev, dt = means2d.device, means2d.dtype
    tiles_w = -(-width // tile_size)
    tiles_h = -(-height // tile_size)

    order = depth_sort_order(depths, radii)
    m = means2d[order]
    con = conics[order]
    col = colors[order]
    op = opacities[order]
    rad = radii[order]
    tminx, tmaxx, tminy, tmaxy = tile_bounds(m, rad, tile_size, tiles_w, tiles_h)
    valid = rad > 0

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dt, device=dev),
        torch.arange(width, dtype=dt, device=dev),
        indexing="ij",
    )
    px_all = (xs + 0.5).reshape(-1)
    py_all = (ys + 0.5).reshape(-1)
    tx_all = torch.div(xs.reshape(-1), tile_size, rounding_mode="floor").to(torch.int32)
    ty_all = torch.div(ys.reshape(-1), tile_size, rounding_mode="floor").to(torch.int32)

    renders, alphas = [], []
    for s in range(0, height * width, pixel_chunk):
        px = px_all[s : s + pixel_chunk, None]
        py = py_all[s : s + pixel_chunk, None]
        tx = tx_all[s : s + pixel_chunk, None]
        ty = ty_all[s : s + pixel_chunk, None]
        dx = m[None, :, 0] - px  # (P, N)
        dy = m[None, :, 1] - py
        sigma = 0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy) + con[None, :, 1] * dx * dy
        alpha = torch.clamp(op[None, :] * torch.exp(-sigma), max=MAX_ALPHA)
        in_tile = (tx >= tminx[None]) & (tx < tmaxx[None]) & (ty >= tminy[None]) & (ty < tmaxy[None])
        vis = in_tile & valid[None] & (sigma >= 0) & (alpha >= ALPHA_THRESHOLD)
        a_eff = torch.where(vis, alpha, torch.zeros_like(alpha))
        one_minus = 1.0 - a_eff
        incl_T = torch.cumprod(one_minus, dim=-1)
        excl_T = incl_T / one_minus
        terminated = torch.cummax((incl_T <= TRANSMITTANCE_EPS).to(torch.int32), dim=1).values > 0
        w = torch.where(vis & ~terminated, a_eff * excl_T, torch.zeros_like(a_eff))
        renders.append(w @ col)
        alphas.append(w.sum(-1))
    render = torch.cat(renders).reshape(height, width, -1)
    alpha = torch.cat(alphas).reshape(height, width, 1)
    return render, alpha, 1.0 - alpha[..., 0]
