"""Offline depth / color rendering over a list of cameras.

Twin of `freegaussian_tpu/preprocess/render_offline.py`: expected-depth
`.npy` files divided by the dataparser scale, and RGB images written as PNG
with the standard library (`viewer/png.py`) instead of imageio.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from ..data.cameras import Camera
from ..models.fields import DeformField
from ..models.gaussians import GaussianParams
from ..models.splat_model import SplatConfig, forward
from ..viewer.png import encode_png
from ..viewer.server import to_rgb8


def render_depth_maps(
    cfg: SplatConfig,
    params: GaussianParams,
    alive,
    cameras: Iterable[Camera],
    out_dir: Path,
    *,
    dataparser_scale: float = 1.0,
    deform: Optional[DeformField] = None,
    names: Optional[Iterable[str]] = None,
) -> int:
    """Render expected depth per camera, divide by the dataparser scale and
    save `<name>.npy`. Returns the number of files written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = list(names) if names is not None else None
    count = 0
    for i, cam in enumerate(cameras):
        out = forward(
            cfg, params, alive, cam, deform=deform, sh_degree_now=0,
            warmed_up=deform is not None, train=False, render_mode="RGB+ED",
        )
        depth = out["depth"][..., 0].cpu().numpy() / dataparser_scale
        np.save(out_dir / f"{names[i] if names else f'{i:05d}'}.npy", depth)
        count += 1
    return count


def render_color_images(
    cfg: SplatConfig,
    params: GaussianParams,
    alive,
    cameras: Iterable[Camera],
    out_dir: Path,
    *,
    sh_degree: int = 3,
    deform: Optional[DeformField] = None,
    names: Optional[Iterable[str]] = None,
) -> int:
    """Render RGB per camera and save `<name>.png`. Returns the count."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = list(names) if names is not None else None
    count = 0
    for i, cam in enumerate(cameras):
        out = forward(
            cfg, params, alive, cam, deform=deform, sh_degree_now=sh_degree,
            warmed_up=deform is not None, train=False, render_mode="RGB",
        )
        name = names[i] if names else f"{i:05d}"
        (out_dir / f"{name}.png").write_bytes(encode_png(to_rgb8(out["rgb"])))
        count += 1
    return count
