"""SSIM (twin of `freegaussian_tpu/models/ssim.py`), matching
pytorch_msssim.SSIM(data_range=1.0, size_average=True) as the reference loss
uses it: an 11-tap Gaussian window (sigma 1.5), separable, valid padding,
K1 = 0.01, K2 = 0.03.

The five blurred maps (mu1, mu2, E[x^2], E[y^2], E[xy]) go through one
depthwise convolution per axis, stacked as channels. Convolutions run in
full f32 on the GPU (cuDNN's TF32 default is turned off), so the map agrees
with the JAX package's exact-f32 shifted sums to f32 rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.math import device_constant


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    g /= g.sum()
    return g.astype(np.float32)


def _separable_blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid separable filter of every channel of x (B, C, H, W)."""
    c = x.shape[1]
    k = win.shape[0]
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim_map(
    img1: torch.Tensor,
    img2: torch.Tensor,
    *,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-window SSIM map (valid windows only): (B, C, H - w + 1, W - w + 1)."""
    if img1.ndim == 3:  # (H, W, C) -> (1, C, H, W)
        img1 = img1.permute(2, 0, 1)[None]
        img2 = img2.permute(2, 0, 1)[None]
    if img1.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
    # Clamp the window to the image; keep it odd.
    max_win = min(img1.shape[2], img1.shape[3])
    if win_size > max_win:
        win_size = max_win if max_win % 2 == 1 else max_win - 1
    win = device_constant(_gaussian_window(win_size, win_sigma), torch.float32, img1.device)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    c = img1.shape[1]
    blurred = _separable_blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1), win)
    mu1, mu2, e11, e22, e12 = blurred.split(c, dim=1)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2

    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map


def ssim(img1: torch.Tensor, img2: torch.Tensor, **kwargs) -> torch.Tensor:
    """Structural similarity between (H, W, C) or (B, C, H, W) images."""
    return torch.mean(ssim_map(img1, img2, **kwargs))
