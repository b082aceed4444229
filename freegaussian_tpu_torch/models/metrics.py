"""LPIPS (twin of `freegaussian_tpu/models/metrics.py`): the AlexNet-LPIPS
of lpips v0.1 ('alex'), the perceptual metric the reference reports per
eval image (freegaussian_model.py:1005-1051).

It needs pretrained weights, and the port fetches none. `lpips()` runs when
a local weights file exists, in the JAX package's npz layout
(`conv{i}_w` (O, I, Kh, Kw), `conv{i}_b` (O,), `lin{i}` (C,) for i in
0..4): `$FREEGAUSSIAN_LPIPS_WEIGHTS`, else
`~/.cache/freegaussian/lpips_alex.npz` (the JAX package's
scripts/export_lpips_weights.py writes one on a machine with the `lpips`
package). Without it, `lpips()` returns None and eval reports carry NaN
with `lpips_available` False.

The network runs on the images' device with PyTorch's convolutions and
max-pools (the JAX package computes it with XLA's, outside any kernel of
its own), in full f32: TF32 is off for its convolutions.
"""

from __future__ import annotations

import os
import warnings
import zipfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet-LPIPS architecture (lpips v0.1 'alex'): (out channels, kernel,
# stride, padding) of the five feature slices' convolutions; a 3x3 / 2
# max-pool follows slices 0 and 1.
ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
# the input scaling layer (lpips ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (weights path, device) -> the network's tensors, or None where the file is missing
_nets: Dict[Tuple[str, str], Optional[dict]] = {}
_warned = False


def default_weights_path() -> Path:
    env = os.environ.get("FREEGAUSSIAN_LPIPS_WEIGHTS", "")
    if env:
        return Path(env)
    return Path(os.path.expanduser("~/.cache/freegaussian/lpips_alex.npz"))


def _network(device: torch.device) -> Optional[dict]:
    """The weights of `default_weights_path()` on `device`, loaded once; None
    without a file (or, with a warning, a file that does not load)."""
    path = default_weights_path()
    key = (str(path), str(device))
    if key not in _nets:
        net = None
        if path.exists():
            try:
                with np.load(path) as f:
                    t = lambda name: torch.as_tensor(np.asarray(f[name], np.float32), device=device)
                    net = {
                        "convs": [(t(f"conv{i}_w"), t(f"conv{i}_b")) for i in range(len(ALEX_CONVS))],
                        "lins": [t(f"lin{i}").reshape(1, -1, 1, 1) for i in range(len(ALEX_CONVS))],
                    }
            except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
                warnings.warn(f"LPIPS weights at {path} failed to load: {e}")
        _nets[key] = net
    return _nets[key]


def _features(x: torch.Tensor, convs) -> list:
    """The five ReLU taps of images x (B, 3, H, W) in [-1, 1]."""
    shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    x = (x - shift) / scale
    taps = []
    for i, ((w, b), (_, _, stride, pad)) in enumerate(zip(convs, ALEX_CONVS)):
        x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        taps.append(x)
        if i < 2:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


@torch.no_grad()
def lpips(pred: torch.Tensor, gt: torch.Tensor) -> Optional[float]:
    """LPIPS (alex) between two (H, W, 3) images in [0, 1] on one device,
    computed there; None when no weights file exists (the caller records
    NaN and `lpips_available` False)."""
    global _warned
    net = _network(pred.device)
    if net is None:
        if not _warned:
            warnings.warn(
                f"LPIPS weights not found at {default_weights_path()}; eval reports carry lpips NaN "
                "(lpips_available False)"
            )
            _warned = True
        return None
    x = torch.stack([pred, gt]).float().clamp(0, 1).mul(2).sub(1).permute(0, 3, 1, 2).contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        taps = _features(x, net["convs"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    total = torch.zeros((), device=pred.device)
    for f, lin in zip(taps, net["lins"]):
        # lpips normalize_tensor puts the eps outside the sqrt
        f = f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)
        total = total + torch.mean(torch.sum((f[0:1] - f[1:2]) ** 2 * lin, dim=1))
    return float(total)
