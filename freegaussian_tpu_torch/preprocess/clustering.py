"""Gaussian clustering (twin of `freegaussian_tpu/preprocess/clustering.py`):
vote per-frame articulation masks onto Gaussians, and the mask file.

For each key frame (reference preprocess/knn_gaussian.py:26-184):
  - with a deform field, move the Gaussians' centers to the frame's time;
  - render expected depth ("ED" mode: the compositor at one channel) and
    project the centers;
  - keep Gaussians whose projected center is in bounds and depth-consistent,
    depth_low * d < d_pixel - d_gaussian < depth_high * d (ref :116-124);
  - vote: the annotation mask at the center pixel (ref :127-132).
The votes are counted over the key frames on the Gaussians' device.

`gaussian_mask_NxM.npy` holds one bool row per live Gaussian of the
checkpoint, in order (the reference layout, preprocess/knn_gaussian.py:162-165);
in memory the mask is padded to the model's capacity and aligned with its
alive rows.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.cameras import Camera
from ..models.fields import DeformField, apply_se3_deform
from ..models.gaussians import GaussianParams
from ..ops.rasterize import rasterization


@torch.no_grad()
def vote_gaussian_masks_one_frame(
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    atrb_mask: torch.Tensor,  # (H, W, M) bool, on the Gaussians' device
    *,
    deform: Optional[DeformField] = None,
    backend: str = "auto",
    depth_low: float = -0.1,
    depth_high: float = 1.0,
    min_alpha: float = 0.0,
) -> torch.Tensor:
    """(N, M) bool votes of one key frame.

    `min_alpha` also requires the center pixel's accumulated alpha above
    it: expected depth is accumulated depth / alpha, ill-conditioned at
    near-transparent pixels, where votes flip with the last bits of the
    compositor. 0.0 is the reference's behavior (no gate)."""
    means = params["means"]
    if deform is not None:
        d_xyz, _, _ = deform(means, camera.time.reshape(1, 1), live=alive)
        means = apply_se3_deform(means, d_xyz)
    render, alpha_img, info = rasterization(
        means,
        params["quats"],
        torch.exp(params["scales"]),
        torch.sigmoid(params["opacities"][..., 0]),
        params["features_dc"],  # colors, unused in ED mode
        camera.viewmat[None],
        camera.K[None],
        camera.width,
        camera.height,
        render_mode="ED",
        sh_degree=None,
        alive=alive,
        backend=backend,
    )
    depth_img = render[0, ..., 0]

    h, w = camera.height, camera.width
    xy = info.means2d
    # round half to even, as jnp.round
    xi = torch.clamp(torch.round(xy[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).long(), 0, h - 1)
    in_bounds = (xy[:, 0] >= 0) & (xy[:, 0] < w) & (xy[:, 1] >= 0) & (xy[:, 1] < h)
    visible = (info.radii > 0) & in_bounds & alive

    d_gauss = info.depths
    diff = depth_img[yi, xi] - d_gauss
    keep = visible & (diff > depth_low * d_gauss) & (diff < depth_high * d_gauss)
    if min_alpha > 0.0:
        keep &= alpha_img[0, yi, xi, 0] > min_alpha
    return atrb_mask[yi, xi] & keep[:, None]


def cluster_gaussians(
    params: GaussianParams,
    alive: torch.Tensor,
    key_frames: Dict[int, np.ndarray],  # frame index -> (H, W, M+1) bool mask
    cameras: Dict[int, Camera],
    *,
    deform: Optional[DeformField] = None,
    backend: str = "auto",
    mask_valids: Optional[Dict[int, np.ndarray]] = None,
    drop_background: bool = True,
    exclusive: bool = False,
    depth_low: float = -0.1,
    depth_high: float = 1.0,
    min_vote_frac: float = 0.0,
    min_alpha: float = 0.0,
) -> torch.Tensor:
    """Count the votes over every key frame -> the (N, M) bool gaussian mask
    on the Gaussians' device. With `deform` each frame deforms the centers
    to its time (the `cluster --dynamic` verb).

    Annotation masks carry the attributes at channels [0, M) and the
    background last (the reference's load_*_annotations); the vote uses the
    attribute channels only, gated per frame by `mask_valids`
    (knn_gaussian.py:128), where a single flag (the blender annotations)
    keeps or skips the whole frame. `drop_background=False` takes masks
    without a background channel.

    `exclusive=False` is the reference's boolean OR: a Gaussian belongs to
    every attribute it was voted into. `exclusive=True` keeps only its
    most-voted attribute (the first on a tie). `min_vote_frac` requires
    the winning attribute's votes in at least this fraction of the key
    frames (0.0: one vote suffices, the reference)."""
    n = params["means"].shape[0]
    dev = params["means"].device
    counts = None
    for idx, atrb_np in key_frames.items():
        atrb = torch.as_tensor(np.asarray(atrb_np, bool), device=dev)
        if drop_background:
            atrb = atrb[..., :-1]
        if mask_valids is not None and idx in mask_valids:
            valid = np.asarray(mask_valids[idx]).reshape(-1)
            if valid.shape[0] <= 1:
                # blender annotations carry a single whole-frame flag
                if not bool(valid.all()):
                    continue
            else:
                if drop_background:
                    valid = valid[:-1]
                if valid.shape[0] == atrb.shape[-1]:
                    atrb = atrb & torch.as_tensor(valid, device=dev)[None, None, :]
        votes = vote_gaussian_masks_one_frame(
            params, alive, cameras[idx], atrb, deform=deform, backend=backend,
            depth_low=depth_low, depth_high=depth_high, min_alpha=min_alpha,
        ).to(torch.int32)
        counts = votes if counts is None else counts + votes
    if counts is None:
        return torch.zeros((n, 0), dtype=torch.bool, device=dev)
    min_votes = max(int(math.ceil(min_vote_frac * len(key_frames))), 1)
    if exclusive:
        winner = torch.argmax(counts, dim=-1, keepdim=True)  # the first maximal index, as jnp.argmax
        one_hot = torch.zeros_like(counts, dtype=torch.bool).scatter_(1, winner, True)
        return one_hot & (counts.amax(dim=-1, keepdim=True) >= min_votes)
    return counts >= min_votes  # min_votes 1: the reference's boolean OR


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
