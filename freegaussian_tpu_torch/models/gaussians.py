"""Gaussian parameter set with padded capacity and its initialization (twin
of `freegaussian_tpu/models/gaussians.py`).

Parameters live in fixed-capacity (N_max) tensors plus an `alive` mask, the
layout the JAX package trains in, so states compare row for row. Group names
follow the reference optimizer groups: means, scales, quats, features_dc,
features_rest (stored flat as (N, (K-1)*3), coefficient-major), opacities.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.math import num_sh_bases, random_quat, rgb_to_sh

GaussianParams = Dict[str, torch.Tensor]

PARAM_NAMES = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


def colors_from_features(params: GaussianParams) -> torch.Tensor:
    """(N_max, K, 3) SH coefficient stack (dc + rest)."""
    rest = params["features_rest"]
    rest = rest.reshape(rest.shape[0], rest.shape[1] // 3, 3)
    return torch.cat([params["features_dc"][:, None, :], rest], dim=1)


def knn_mean_dist(points: torch.Tensor, k: int = 3, block: int = 4096) -> torch.Tensor:
    """Mean distance of each point to its k nearest other points, by
    `torch.cdist` over blocks of query rows (the reference's sklearn KNN,
    freegaussian_model.py:293-311, without sklearn)."""
    n = points.shape[0]
    k = min(k, n - 1)
    if k < 1:
        return torch.full((n,), 0.1, dtype=torch.float32, device=points.device)
    pts = points.float()
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for s in range(0, n, block):
        d = torch.cdist(pts[s : s + block], pts, compute_mode="donot_use_mm_for_euclid_dist")
        # the point itself is at distance 0: drop the smallest of k + 1
        nearest = torch.topk(d, k + 1, dim=1, largest=False).values
        out[s : s + block] = nearest[:, 1:].mean(dim=1)
    return out


def init_gaussians(
    capacity: int,
    *,
    generator: Optional[torch.Generator] = None,
    seed_points: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
    num_random: int = 50000,
    random_scale: float = 10.0,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    device="cuda",
) -> Tuple[GaussianParams, torch.Tensor]:
    """The padded parameter dict and alive mask (twin of
    `freegaussian_tpu/models/gaussians.py:init_gaussians`): scales =
    log(mean 3-NN distance), random unit quats, logit(init_opacity)
    opacities, SH DC from the seed RGB (0-255) else uniform random, higher
    SH zero. Random draws come from `generator` (on `device`'s type)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if seed_points is not None:
        xyz = torch.as_tensor(np.asarray(seed_points[0], np.float32), device=dev)
        n = xyz.shape[0]
    else:
        n = num_random
        xyz = (torch.rand((n, 3), generator=generator, device=dev) - 0.5) * random_scale
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial gaussians {n}")

    dim_sh = num_sh_bases(sh_degree)
    avg_dist = knn_mean_dist(xyz, 3)
    scales = torch.log(torch.clamp(avg_dist, min=1e-7))[:, None].repeat(1, 3)
    quats = random_quat(n, generator=generator, device=dev)
    if seed_points is not None and seed_points[1] is not None and len(seed_points[1]):
        features_dc = rgb_to_sh(torch.as_tensor(np.asarray(seed_points[1], np.float32), device=dev) / 255.0)
    else:
        features_dc = torch.rand((n, 3), generator=generator, device=dev)
    features_rest = torch.zeros((n, (dim_sh - 1) * 3), device=dev)
    opacities = torch.full((n, 1), math.log(init_opacity / (1 - init_opacity)), device=dev)

    def pad(x):
        return torch.cat([x.float(), x.new_zeros((capacity - n, *x.shape[1:]), dtype=torch.float32)])

    params = {
        "means": pad(xyz), "scales": pad(scales), "quats": pad(quats),
        "features_dc": pad(features_dc), "features_rest": pad(features_rest), "opacities": pad(opacities),
    }
    alive = torch.arange(capacity, device=dev) < n
    return params, alive
