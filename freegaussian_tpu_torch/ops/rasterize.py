"""Public rasterization API: project -> SH -> tile rasterize, differentiable.

Torch twin of `freegaussian_tpu/ops/rasterize.py:rasterization`, with the
same signature and `RasterizeInfo`:

  render, alpha, info = rasterization(
      means, quats, scales, opacities, colors, viewmats, Ks, width, height,
      tile_size=16, render_mode in {"RGB", "RGB+ED", "ED"}, sh_degree,
      rasterize_mode in {"classic", "antialiased"}, extra_channels, ...)

The pixel stage is `ops/rasterize_cuda.py:rasterize_pixels`: the CUDA tile
compositor and its backward on a GPU, their plain PyTorch versions on the
CPU. Everything is differentiable in the Gaussians' attributes.
`means2d_sink` (N, 2), zeros, collects the AbsGS absgrad as its gradient:
on the tile path the per-kernel-tile |d means2d| summed per Gaussian; with
`backend="reference"` it rides means2d, giving the signed gradient (as the
JAX package's oracle backend does). The arguments that serve the clustering
and multi-chip paths (`packed`, `gather_axis`, a band `tile_origin_y`) raise
NotImplementedError until the slices that port them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import project_gaussians
from .rasterize_cuda import rasterize_pixels
from .rasterize_ref import ALPHA_THRESHOLD, rasterize_pixels_reference, tile_bounds
from .sh import sh_colors_for_camera


def tighten_radii(radii: torch.Tensor, opacities: torch.Tensor) -> torch.Tensor:
    """Opacity-aware screen radius, exact for the pixel stage: every pixel
    farther than sqrt(2 ln(op / thresh)) sqrt(v1max) from the center
    composites to zero, so the 3-sigma radius shrinks by that factor / 3
    without changing an output bit. Stays fractional; `info.radii` keeps the
    int 3-sigma radii."""
    op = opacities.detach()
    s2 = 2.0 * torch.log(torch.clamp(op, min=1e-30) / ALPHA_THRESHOLD)
    factor = torch.clamp(torch.sqrt(torch.clamp(s2, min=0.0)) * (1.0 / 3.0), max=1.0)
    r = radii.float() * factor
    return torch.where(op > ALPHA_THRESHOLD, r, torch.zeros_like(r))


class RasterizeInfo(NamedTuple):
    means2d: torch.Tensor  # (N, 2) projected centers
    radii: torch.Tensor  # (N,) int32
    depths: torch.Tensor  # (N,)
    conics: torch.Tensor  # (N, 3)
    compensations: torch.Tensor  # (N,)
    num_isects: int  # tile intersections this frame
    gaussian_ids: torch.Tensor | None = None
    isect_means2d: torch.Tensor | None = None
    isect_depths: torch.Tensor | None = None
    tile_ids: torch.Tensor | None = None


def rasterization(
    means: torch.Tensor,  # (N, 3)
    quats: torch.Tensor,  # (N, 4) wxyz
    scales: torch.Tensor,  # (N, 3) linear-space
    opacities: torch.Tensor,  # (N,) post-sigmoid
    colors: torch.Tensor,  # (N, C) precomputed or (N, K, 3) SH coefficients
    viewmats: torch.Tensor,  # (1, 4, 4) or (4, 4) world-to-camera
    Ks: torch.Tensor,  # (1, 3, 3) or (3, 3)
    width: int,
    height: int,
    *,
    tile_size: int = 16,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    render_mode: str = "RGB",
    sh_degree: int | None = None,
    absgrad: bool = False,
    rasterize_mode: str = "classic",
    radius_clip: float = 0.0,
    alive: torch.Tensor | None = None,
    means2d_sink: torch.Tensor | None = None,
    extra_channels: torch.Tensor | None = None,
    backend: str = "auto",
    chunk: int = 128,
    isect_capacity: int | None = None,
    tight_radius: bool = True,
    packed: bool = False,
    gather_axis: str | None = None,
    tile_origin_y: int = 0,
    proj_height: int | None = None,
):
    """Render N Gaussians through one camera.

    Returns (render (1, H, W, C_out), alpha (1, H, W, 1), info). For "RGB+ED"
    the last channel is expected depth (accumulated depth normalized by
    alpha); for "ED" the single channel is expected depth. `backend`
    "reference" runs the dense oracle instead of the tile path; `chunk` and
    `isect_capacity` size the TPU's static buffers and are not used here
    (the port bins exactly `num_isects` slots). `absgrad` is accepted for
    the gsplat signature: the absgrad statistic comes through
    `means2d_sink`."""
    if rasterize_mode not in ("classic", "antialiased"):
        raise ValueError(f"Unknown rasterize_mode: {rasterize_mode}")
    if render_mode not in ("RGB", "RGB+ED", "ED"):
        raise ValueError(f"Unknown render_mode: {render_mode}")
    if backend not in ("auto", "pallas", "reference"):
        raise ValueError(f"Unknown backend: {backend}")
    if packed:
        raise NotImplementedError("packed=True comes with the clustering slice of the port")
    if gather_axis is not None or tile_origin_y != 0:
        raise NotImplementedError("gather_axis and band rendering come with the multi-GPU slice of the port")

    viewmat = viewmats.reshape(-1, 4, 4)[0]
    K = Ks.reshape(-1, 3, 3)[0]
    proj = project_gaussians(
        means, quats, scales, viewmat, K, width,
        proj_height if proj_height is not None else height,
        near_plane=near_plane, far_plane=far_plane, radius_clip=radius_clip,
        calc_compensations=(rasterize_mode == "antialiased"), alive=alive,
    )
    means2d = proj.means2d
    sink_for_pixels = None
    if means2d_sink is not None:
        if backend == "reference":
            # the oracle's plain autodiff gives the signed screen gradient
            means2d = means2d + means2d_sink
        else:
            sink_for_pixels = means2d_sink

    if sh_degree is not None:
        rgb = sh_colors_for_camera(colors, means, viewmat, sh_degree)
    else:
        rgb = colors
    if rgb.ndim == 3:
        rgb = rgb[:, 0, :]

    opac = opacities
    if rasterize_mode == "antialiased":
        opac = opac * proj.compensations

    if render_mode == "RGB":
        channels = rgb
    elif render_mode == "RGB+ED":
        channels = torch.cat([rgb, proj.depths[:, None]], dim=-1)
    else:
        channels = proj.depths[:, None]
    if extra_channels is not None:
        # inserted before the depth channel so the ED normalization below
        # still addresses the last channel
        if render_mode in ("RGB+ED", "ED"):
            channels = torch.cat([channels[..., :-1], extra_channels, channels[..., -1:]], dim=-1)
        else:
            channels = torch.cat([channels, extra_channels], dim=-1)

    radii_pixel = tighten_radii(proj.radii, opac) if tight_radius else proj.radii.float()

    if backend == "reference":
        render, alpha, _ = rasterize_pixels_reference(
            means2d, proj.conics, channels, opac, proj.depths, radii_pixel,
            width, height, tile_size=tile_size,
        )
        tiles_w = -(-width // tile_size)
        tiles_h = -(-height // tile_size)
        tnx, tmx, tny, tmy = tile_bounds(means2d.detach(), radii_pixel, tile_size, tiles_w, tiles_h)
        num_isects = int(torch.sum(torch.where(radii_pixel > 0, (tmx - tnx) * (tmy - tny), 0)))
    else:
        render, alpha, num_isects = rasterize_pixels(
            means2d, proj.conics, channels, opac, proj.depths, radii_pixel,
            width, height, tile_size=tile_size, means2d_sink=sink_for_pixels,
        )

    if render_mode in ("RGB+ED", "ED"):
        depth = render[..., -1:] / torch.clamp(alpha, min=1e-10)
        render = torch.cat([render[..., :-1], depth], dim=-1)

    info = RasterizeInfo(
        means2d=means2d,
        radii=proj.radii,
        depths=proj.depths,
        conics=proj.conics,
        compensations=proj.compensations,
        num_isects=num_isects,
    )
    return render[None], alpha[None], info
