"""The benchmark's inputs, made from `--seed`: the scene, the field weights,
the control mask, the cameras and the dataset on disk.

The scene is the JAX `bench.py` operating point, as the frozen recipe of
`chip_smoke.py:synthetic_gaussians`, `synthetic_field_state`,
`synthetic_mask` and `bench_camera` has it: N(0, 1) means, scales
log 0.015, SH degree 3 with N(0, 0.05) higher bands, the 50/30/20 opacity
mixture over [0.55, 0.99], [0.1, 0.55] and [0.02, 0.1], field weights at
torch's default U(+-1/sqrt(fan_in)) with the heads x 0.01. Here every draw
comes from one `torch.Generator` on the run's device, in a few large calls,
so a seed gives the same tensors on every run of one device.

The dataset is `chip_smoke.py:phase_dataset`'s layout (`parse_synthetic`:
transforms.json, images/, depth/, interflow_n2/, mask/) with seeded depth
U(3, 8), interflow N(0, 1) px and three seeded attribute boxes per frame;
the images are rendered by the benchmark's reference (`reference/`) from
the seeded scene. The cameras ring the scene at radius 6 in the z = 0 plane
with +z up, so `parse_synthetic`'s orientation and centring leave them as
they are.
"""

from __future__ import annotations

import json
import math
import struct
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from reference import core

DEFORM_SHAPES = (
    [("timenet.0", 256, 13), ("timenet.2", 30, 256)]
    + [(f"linear.{i}", 256, 93 if i == 0 else (256 + 93 if i == 5 else 256)) for i in range(8)]
    + [("branch_w", 3, 256), ("branch_v", 3, 256), ("gaussian_rotation", 4, 256), ("gaussian_scaling", 3, 256)]
)
CONTROL_SHAPES = (
    [(f"linear.{i}", 256, 126 if i == 0 else (256 + 126 if i == 5 else 256)) for i in range(8)]
    + [("d_xyz", 3, 256), ("d_rot", 4, 256), ("d_scale", 3, 256)]
)


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on `device` for one kind of input of the run's seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + salt) % (1 << 63))


def gaussians(n: int, seed: int, device, sh_degree: int = 3) -> Dict[str, torch.Tensor]:
    """The bench scene's (n, ...) parameters in the port's layout."""
    g = generator(seed, 1, device)
    k = (sh_degree + 1) ** 2
    normal = torch.randn((n, 3 + 4 + 3 * (k - 1)), generator=g, device=device)
    uniform = torch.rand((n, 5), generator=g, device=device)
    quats = normal[:, 3:7] / torch.linalg.vector_norm(normal[:, 3:7], dim=-1, keepdim=True)
    u = uniform[:, 0]
    op = torch.where(
        u < 0.5, 0.55 + 0.44 * uniform[:, 1], torch.where(u < 0.8, 0.1 + 0.45 * uniform[:, 1], 0.02 + 0.08 * uniform[:, 1])
    )
    return {
        "means": normal[:, 0:3].contiguous(),
        "scales": torch.full((n, 3), math.log(0.015), device=device),
        "quats": quats.contiguous(),
        "features_dc": ((uniform[:, 2:5] - 0.5) / core.SH_C0).contiguous(),
        "features_rest": (0.05 * normal[:, 7:]).contiguous(),
        "opacities": torch.log(op / (1.0 - op))[:, None].contiguous(),
    }


def perturbed(params: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
    """The trainer's starting point: the scene with seeded noise on the
    means (0.01), colours (0.1) and opacity logits (0.3), so that the
    residuals are not zero."""
    g = generator(seed, 2, params["means"].device)
    noise = torch.randn((params["means"].shape[0], 9), generator=g, device=params["means"].device)
    out = dict(params)
    out["means"] = params["means"] + 0.01 * noise[:, 0:3]
    out["features_dc"] = params["features_dc"] + 0.1 * noise[:, 3:6]
    out["opacities"] = params["opacities"] + 0.3 * noise[:, 6:7]
    return out


def field_weights(shapes, heads, seed: int, salt: int, device, head_scale: float = 0.01) -> Dict[str, torch.Tensor]:
    """U(+-1/sqrt(fan_in)) for every layer, the heads x `head_scale`, drawn
    in one call."""
    g = generator(seed, salt, device)
    total = sum(o * i + o for _, o, i in shapes)
    flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, o, i in shapes:
        scale = (1.0 / math.sqrt(i)) * (head_scale if name in heads else 1.0)
        out[f"{name}.weight"] = (flat[at : at + o * i].reshape(o, i) * scale).contiguous()
        at += o * i
        out[f"{name}.bias"] = (flat[at : at + o] * scale).contiguous()
        at += o
    return out


def deform_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    return field_weights(DEFORM_SHAPES, core.DEFORM_HEADS, seed, 3, device)


def control_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    return field_weights(CONTROL_SHAPES, core.CONTROL_HEADS, seed, 4, device)


def control_mask(means: torch.Tensor, seed: int) -> torch.Tensor:
    """`synthetic_mask`: three balls around seeded points of the cloud, each
    holding ~12% of the Gaussians, the first two overlapping."""
    g = generator(seed, 5, means.device)
    pick = torch.randint(0, means.shape[0], (2,), generator=g, device=means.device)
    off = 0.6 * torch.randn(3, generator=g, device=means.device)
    c0 = means[pick[0]] * 0.5
    centers = [c0, c0 + off, means[pick[1]] * 0.5]
    cols = []
    for c in centers:
        d = torch.linalg.vector_norm(means - c, dim=-1)
        cols.append(d <= torch.quantile(d, 0.12))
    return torch.stack(cols, dim=-1)


# ----------------------------------------------------------------------------
# cameras and the dataset


def ring_poses(num_frames: int, radius: float = 6.0) -> np.ndarray:
    """(F, 4, 4) OpenGL camera-to-world matrices on a ring in the z = 0
    plane, looking at the origin, +z up: the mean position is the origin
    and the mean up vector +z."""
    out = []
    for i in range(num_frames):
        phi = 2.0 * math.pi * i / num_frames
        eye = radius * np.array([math.cos(phi), math.sin(phi), 0.0])
        fwd = -eye / radius
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
        out.append(c2w)
    return np.stack(out)


def oriented(poses: np.ndarray) -> np.ndarray:
    """nerfstudio's `auto_orient_and_center_poses(method="up",
    center_method="poses")` as `data/dataparsers.py` computes it (frozen
    copy): rotate the mean up vector onto +z, centre the positions."""
    poses = np.asarray(poses, np.float64)
    a = poses[:, :3, 1].mean(axis=0)
    a = a / np.linalg.norm(a)
    b = np.array([0.0, 0.0, 1.0])
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        rot = np.eye(3) if c > 0 else -np.eye(3)
    else:
        skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))
    transform = np.concatenate([rot, rot @ -poses[:, :3, 3].mean(axis=0)[:, None]], axis=-1)
    out = np.einsum("ij,njk->nik", transform[:3, :3], poses[:, :3, :4])
    out[:, :3, 3] += transform[:3, 3]
    return out.astype(np.float32)


def split(num_frames: int, fraction: float = 0.9):
    """`train_eval_split_fraction` (frozen copy): (train ids, eval ids)."""
    num_train = math.ceil(num_frames * fraction)
    i_train = np.linspace(0, num_frames - 1, num_train, dtype=int)
    return i_train, np.setdiff1d(np.arange(num_frames), i_train)


def frames_of(num_frames: int, width: int, height: int, focal: float, interval: int = 2) -> List[dict]:
    """Every frame's camera as `parse_synthetic` reads it back: oriented
    c2w, the paired frame (interval back, clamped at 0), times i / (F - 1)."""
    poses = ring_poses(num_frames)
    ori = oriented(poses)
    out = []
    for i in range(num_frames):
        prev = max(i - interval, 0)
        out.append({
            "index": i, "prev": prev, "c2w_written": poses[i], "c2w": ori[i, :3, :4], "c2w0": ori[prev, :3, :4],
            "time": i / max(num_frames - 1, 1), "time0": prev / max(num_frames - 1, 1),
            "fx": focal, "fy": focal, "cx": width / 2.0, "cy": height / 2.0, "width": width, "height": height,
        })
    return out


def png_bytes(rgb8: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (no filter, zlib level 1)."""
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def frame_arrays(frames: List[dict], seed: int, device):
    """Seeded per-frame depth (H, W, 1) U(3, 8), interflow (H, W, 2) N(0, 1)
    px and (H, W, 3) attribute boxes, as device tensors."""
    g = generator(seed, 6, device)
    h, w = frames[0]["height"], frames[0]["width"]
    f = len(frames)
    depth = 3.0 + 5.0 * torch.rand((f, h, w, 1), generator=g, device=device)
    flow = torch.randn((f, h, w, 2), generator=g, device=device)
    corners = torch.rand((f, 3, 2), generator=g, device=device)
    ys = torch.arange(h, device=device)[None, :, None, None]
    xs = torch.arange(w, device=device)[None, None, :, None]
    y0 = (corners[:, :, 0] * (h // 2)).long()[:, None, None, :]
    x0 = (corners[:, :, 1] * (w // 2)).long()[:, None, None, :]
    mask = (ys >= y0) & (ys < y0 + h // 3) & (xs >= x0) & (xs < x0 + w // 3)
    return depth, flow, mask


def write_dataset(root: Path, frames: List[dict], images8: np.ndarray, depth, flow, mask, interval: int = 2) -> Path:
    """The dataset in `parse_synthetic`'s layout under `root`."""
    for sub in ("images", "depth", f"interflow_n{interval}", "mask"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    depth, flow, mask = depth.cpu().numpy(), flow.cpu().numpy(), mask.cpu().numpy()
    meta = []
    for fr in frames:
        i = fr["index"]
        (root / f"images/frame_{i:04d}.png").write_bytes(png_bytes(images8[i]))
        np.save(root / f"depth/frame_{i:04d}.npy", depth[i])
        np.save(root / f"interflow_n{interval}/frame_{i:04d}.npy", flow[i])
        np.save(root / f"mask/{i:04d}.npy", mask[i])
        meta.append({"file_path": f"./images/frame_{i:04d}", "transform_matrix": fr["c2w_written"].tolist()})
    angle = 2.0 * math.atan(0.5 * frames[0]["width"] / frames[0]["fx"])
    (root / "transforms.json").write_text(json.dumps({"camera_angle_x": angle, "frames": meta}))
    return root
