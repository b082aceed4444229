"""The cluster mask file (twin of `freegaussian_tpu/preprocess/clustering.py`,
its mask I/O only; the clustering vote is not ported yet).

`gaussian_mask_NxM.npy` holds one bool row per live Gaussian of the
checkpoint, in order (the reference layout, preprocess/knn_gaussian.py:162-165);
in memory the mask is padded to the model's capacity and aligned with its
alive rows.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def save_gaussian_mask(path: Path, mask: torch.Tensor, alive: torch.Tensor) -> None:
    """Write the (capacity, M) mask's live rows as gaussian_mask_NxM.npy."""
    np.save(Path(path), mask.detach().cpu().numpy().astype(bool)[alive.detach().cpu().numpy()])


def load_gaussian_mask(path: Path, capacity: int, alive: torch.Tensor) -> torch.Tensor:
    """Load gaussian_mask_NxM.npy (live rows) back into a (capacity, M) bool
    tensor on `alive`'s device, row i of the file on the i-th live slot."""
    live = np.load(Path(path))
    out = np.zeros((capacity, live.shape[1]), bool)
    out[np.where(alive.detach().cpu().numpy())[0][: live.shape[0]]] = live
    return torch.from_numpy(out).to(alive.device)
