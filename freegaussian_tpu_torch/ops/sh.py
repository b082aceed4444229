"""Spherical-harmonics color evaluation (degree <= 4).

Torch twin of `freegaussian_tpu/ops/sh.py` (standard real-SH constants of
gsplat / INRIA 3DGS). `sh_colors_for_camera` adds the camera-position formula
and the `clip(rgb + 0.5, 0)` shift of `freegaussian_tpu/ops/rasterize.py:177-181`.
"""

from __future__ import annotations

import torch

from .math import num_sh_bases

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis at unit directions: (..., 3) -> (..., (degree+1)^2)."""
    if degree < 0 or degree > 4:
        raise ValueError(f"sh degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [_C0 * torch.ones_like(x)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3.0 * xx - yy),
            _C4[2] * xy * (7.0 * zz - 1.0),
            _C4[3] * yz * (7.0 * zz - 3.0),
            _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _C4[5] * xz * (7.0 * zz - 3.0),
            _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _C4[7] * xz * (xx - 3.0 * yy),
            _C4[8] * ((xx - 3.0 * yy) * xx - (yy - 3.0 * xx) * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh_colors(
    sh_coeffs: torch.Tensor,  # (..., K_total, 3), K_total >= (degree+1)^2
    dirs: torch.Tensor,  # (..., 3) view directions
    degree: int,
    *,
    normalize_dirs: bool = True,
) -> torch.Tensor:
    """Raw SH colors (..., 3); coefficients above the active degree are ignored.
    The sum runs over the bases in order, as the JAX package's channelized loop."""
    if normalize_dirs:
        dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
    k = num_sh_bases(degree)
    basis = sh_basis(dirs, degree)  # (..., K)
    acc = basis[..., 0:1] * sh_coeffs[..., 0, :]
    for j in range(1, k):
        acc = acc + basis[..., j : j + 1] * sh_coeffs[..., j, :]
    return acc


def sh_colors_for_camera(sh_coeffs: torch.Tensor, means: torch.Tensor, viewmat: torch.Tensor, degree: int) -> torch.Tensor:
    """Per-Gaussian RGB seen from the camera of `viewmat`: SH along
    (mean - camera position), then `clip(rgb + 0.5, 0)`."""
    camtoworld_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
    rgb = eval_sh_colors(sh_coeffs, means - camtoworld_pos, degree)
    return torch.clamp(rgb + 0.5, min=0.0)
