"""Cluster visualization (twin of `freegaussian_tpu/preprocess/cluster_viz.py`):
the live Gaussians' centers as a PLY point cloud colored by cluster, viewable
in any point-cloud tool."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.ply import write_ply_points

# Distinct colors for up to 10 attributes; unassigned Gaussians are gray.
_PALETTE = np.array(
    [
        [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
        [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
        [210, 245, 60], [250, 190, 190],
    ],
    dtype=np.uint8,
)


def export_cluster_ply(path: Path, means: torch.Tensor, gaussian_mask: torch.Tensor, alive: torch.Tensor) -> None:
    """Write the live rows of `means` (N, 3), each colored by the last of
    its attributes in `gaussian_mask` (N, M) bool (the palette, cycling),
    gray without one."""
    keep = alive.detach().cpu().numpy()
    means = means.detach().cpu().numpy()[keep]
    mask = gaussian_mask.detach().cpu().numpy()[keep]
    colors = np.full((means.shape[0], 3), 128, np.uint8)
    for m in range(mask.shape[1]):
        colors[mask[:, m]] = _PALETTE[m % len(_PALETTE)]
    write_ply_points(path, means.astype(np.float32), colors)
