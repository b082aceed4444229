"""Trained Gaussians in the standard INRIA-3DGS PLY layout (twin of
`freegaussian_tpu/data/splat_export.py`, byte for byte): x y z nx ny nz
f_dc_* f_rest_* opacity scale_* rot_*, loadable by the splat web viewers.

PLYs exported from `antialiased` rasterize mode are not compatible with
classic-mode viewers (the reference's caveat, freegaussian_model.py:110-119).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gaussians import GaussianParams


def export_splat_ply(
    path: Path, params: GaussianParams, alive: torch.Tensor, gaussian_mask: Optional[torch.Tensor] = None
) -> int:
    """Write the live Gaussians; returns how many. Fields are raw
    (pre-activation): log-scales, logit-opacities, unnormalized quats, as
    the INRIA checkpoints keep them.

    `gaussian_mask` (N, M) bool (the stage-2 clustering vote) adds one
    trailing `property float atrb` = 1 + the first attribute index (0 =
    static background); viewers that read properties by name ignore it."""
    keep = alive.detach().cpu().numpy()
    col = lambda name: params[name].detach().cpu().numpy()[keep]
    means, scales, quats = col("means"), col("scales"), col("quats")
    f_dc, f_rest, opac = col("features_dc"), col("features_rest"), col("opacities")
    n = means.shape[0]
    k_rest = f_rest.shape[1] // 3  # explicit: -1 cannot be inferred at n == 0
    # in memory (N, (K-1)*3) coefficient-major; the INRIA layout is channel-major (N, 3, K-1)
    f_rest_flat = f_rest.reshape(n, k_rest, 3).transpose(0, 2, 1).reshape(n, -1)

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(3 * k_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    cols = [means, np.zeros((n, 3), np.float32), f_dc, f_rest_flat, opac.reshape(n, 1), scales, quats]
    if gaussian_mask is not None:
        gm = gaussian_mask.detach().cpu().numpy()[keep]
        atrb = np.where(gm.any(-1), gm.argmax(-1) + 1, 0).astype(np.float32)
        props = props + ["atrb"]
        cols.append(atrb.reshape(n, 1))
    header = (
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + [f"property float {p}" for p in props]
        + ["end_header"]
    )
    data = np.concatenate(cols, axis=-1).astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())
    return n


def import_splat_ply(path: Path) -> Tuple[Dict[str, torch.Tensor], int]:
    """Read an INRIA-layout splat PLY back: (params as f32 CPU tensors in
    the in-memory layout, the Gaussian count)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        n = 0
        props = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header without end_header")
            parts = line.strip().decode("ascii").split()
            if parts == ["end_header"]:
                break
            if parts[:2] == ["element", "vertex"]:
                n = int(parts[2])
            elif parts and parts[0] == "property":
                props.append(parts[2])
        arr = np.frombuffer(f.read(4 * n * len(props)), dtype="<f4").reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}
    pick = lambda names: torch.from_numpy(np.ascontiguousarray(arr[:, [col[p] for p in names]], np.float32))
    k_rest = sum(1 for p in props if p.startswith("f_rest_")) // 3
    f_rest = arr[:, [col[f"f_rest_{i}"] for i in range(3 * k_rest)]]
    params = {
        "means": pick(["x", "y", "z"]),
        "features_dc": pick(["f_dc_0", "f_dc_1", "f_dc_2"]),
        # channel-major PLY layout -> in-memory flat (N, (K-1)*3), coefficient-major
        "features_rest": torch.from_numpy(
            np.ascontiguousarray(f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1), np.float32).reshape(n, 3 * k_rest)
        ),
        "opacities": pick(["opacity"]),
        "scales": pick(["scale_0", "scale_1", "scale_2"]),
        "quats": pick([f"rot_{i}" for i in range(4)]),
    }
    return params, n
