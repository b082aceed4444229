"""Core math ops: quaternions, positional embedding, viewmat convention,
bilinear interpolation, the integer-factor image downsample, SH DC
conversion and learning-rate schedules.

Torch twins of `freegaussian_tpu/ops/math.py` (same formulas, same band and
axis orders) for the functions the serving and training paths need. Every
op here keeps finite gradients on the all-zero rows of dead padded slots
(hence `safe_norm`).
"""

from __future__ import annotations

import math

import torch

_SH_C0 = 0.28209479177387814


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


def random_quat(n: int, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Uniform random unit quaternions (n, 4) wxyz (Shoemake's method)."""
    u, v, w = torch.rand((3, n), generator=generator, device=device)
    return torch.stack(
        [
            torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
            torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
            torch.sqrt(u) * torch.sin(2 * math.pi * w),
            torch.sqrt(u) * torch.cos(2 * math.pi * w),
        ],
        dim=-1,
    )


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0, 1] -> 0th SH coefficient."""
    return (rgb - 0.5) / _SH_C0


def resize_image(image: torch.Tensor, d: int) -> torch.Tensor:
    """Area-downsample an (H, W, C) image by an integer factor d: the mean of
    each d x d block (opencv INTER_AREA for integer factors), rows and
    columns past the last whole block dropped."""
    if d == 1:
        return image
    h, w, c = image.shape
    image = image.float()
    return image[: (h // d) * d, : (w // d) * d].reshape(h // d, d, w // d, d, c).mean(dim=(1, 3))


def bilinear_interp(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation on a batch of images: image (B, H, W, C),
    x, y (B, N) pixel coords (clamped to the image). Returns (B, N, C).
    The standard formulation (not the reference's floor/ceil quirk that
    returns 0 at integer coordinates), as the JAX package keeps it."""
    B, h, w, _ = image.shape
    x = torch.clamp(x, 0, w - 1)
    y = torch.clamp(y, 0, h - 1)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    b = torch.arange(B, device=image.device)[:, None]
    Ia = image[b, y0, x0]
    Ib = image[b, y1, x0]
    Ic = image[b, y0, x1]
    Id = image[b, y1, x1]
    wa = (1 - fx) * (1 - fy)
    wb = (1 - fx) * fy
    wc = fx * (1 - fy)
    wd = fx * fy
    return wa[..., None] * Ia + wb[..., None] * Ib + wc[..., None] * Ic + wd[..., None] * Id


def exponential_decay_schedule(
    lr_init: float,
    lr_final: float,
    max_steps: int,
    warmup_steps: int = 0,
    lr_pre_warmup: float = 1e-8,
):
    """nerfstudio ExponentialDecayScheduler: cosine-eased warmup from
    lr_pre_warmup to lr_init over warmup_steps, then log-linear decay to
    lr_final at max_steps. Returns step -> 0-d f32 tensor, computed in f32
    as the JAX package's schedule is."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        if warmup_steps > 0:
            frac = torch.clamp(step / warmup_steps, 0.0, 1.0)
            warm = lr_pre_warmup + (lr_init - lr_pre_warmup) * torch.sin(0.5 * math.pi * frac)
        else:
            warm = f32(lr_init)
        t = torch.clamp((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0)
        decayed = torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t)
        return torch.where(step < warmup_steps, warm, decayed)

    return schedule
