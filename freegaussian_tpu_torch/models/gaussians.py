"""Gaussian parameter set with padded capacity (twin of `freegaussian_tpu/models/gaussians.py`).

Parameters live in fixed-capacity (N_max) tensors plus an `alive` mask, the
layout the JAX package trains in, so states compare row for row. Group names
follow the reference optimizer groups: means, scales, quats, features_dc,
features_rest (stored flat as (N, (K-1)*3), coefficient-major), opacities.
"""

from __future__ import annotations

from typing import Dict

import torch

GaussianParams = Dict[str, torch.Tensor]

PARAM_NAMES = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


def colors_from_features(params: GaussianParams) -> torch.Tensor:
    """(N_max, K, 3) SH coefficient stack (dc + rest)."""
    rest = params["features_rest"]
    rest = rest.reshape(rest.shape[0], rest.shape[1] // 3, 3)
    return torch.cat([params["features_dc"][:, None, :], rest], dim=1)
