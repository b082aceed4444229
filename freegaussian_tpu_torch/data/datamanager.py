"""Full-image datamanager (twin of `freegaussian_tpu/data/datamanager.py`):
a host-side cache of every frame's image, flow, paired-frame depth and
masks, handed out as device tensors.

Behaviour of the reference's FreeGaussianImageDatamanager
(freegaussian_datamanager.py:28-323), as the JAX package keeps it:
  - every frame is loaded up front (a thread pool);
  - flow `.npy` maps are resized (nearest) to the image;
  - `next_train(step)` returns one (camera, batch), frames drawn without
    replacement from `np.random.default_rng(seed).permutation` epochs, the
    same sequence as the JAX package's, so both train on the same frames in
    the same order;
  - batches stay on the device after first use;
  - a fixed-order eval loader.
Undistortion is not ported yet (it needs cv2's remaps; ROADMAP.md): a frame
with non-zero distortion raises.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..viewer.png import read_png
from .cameras import Camera
from .dataparsers import ParsedDataset


def nearest_resize(a: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, ...) -> (height, width, ...) picking the source pixels
    `cv2.resize(..., interpolation=cv2.INTER_NEAREST)` picks: source index
    floor(dst * (src / dst)), the scale inverted in double precision as
    opencv's resizeNN does, clipped to the last pixel."""
    sh, sw = a.shape[:2]

    def index(dst: int, src: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)

    return a[index(height, sh)][:, index(width, sw)]


def load_flow_npy(filepath: Path, height: int, width: int, scale_factor: float = 1.0) -> np.ndarray:
    """(ref: freegaussian_datamanager.py:211-236 get_flow_image_from_path)"""
    flow = np.load(filepath) * scale_factor
    if flow.shape[:2] != (height, width):
        flow = nearest_resize(flow, height, width)
    return flow.astype(np.float32)


@dataclasses.dataclass
class CachedFrame:
    image: np.ndarray  # (H, W, C) uint8
    camera: Camera
    camera0: Camera
    flow: Optional[np.ndarray] = None
    depth0: Optional[np.ndarray] = None  # paired-frame depth for the 3D lift
    mask: Optional[np.ndarray] = None
    atrb_mask: Optional[np.ndarray] = None
    mask_valid: Optional[np.ndarray] = None


class FullImageDatamanager:
    """Loads every frame of a ParsedDataset into host memory and returns
    batches of tensors on `device`."""

    def __init__(self, parsed: ParsedDataset, *, seed: int = 0, device="cuda"):
        from ..device import resolve_device

        self.parsed = parsed
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self._epoch_order: List[int] = []
        self._device_cache: Dict[int, Tuple[Camera, Dict[str, torch.Tensor]]] = {}
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            self.frames: List[CachedFrame] = list(pool.map(self._load_frame, range(len(parsed))))

    def _load_frame(self, i: int) -> CachedFrame:
        p = self.parsed
        if p.distortion is not None and np.any(p.distortion[i]):
            raise NotImplementedError("undistortion is not ported yet (ROADMAP.md): frame %d has distortion" % i)
        image = read_png(p.image_filenames[i])
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)

        flow = None
        if p.flow_filenames is not None and Path(p.flow_filenames[i]).exists():
            flow = load_flow_npy(p.flow_filenames[i], image.shape[0], image.shape[1])

        depth0 = None
        if p.depth0_filenames is not None and Path(p.depth0_filenames[i]).exists():
            depth0 = np.load(p.depth0_filenames[i]).astype(np.float32)
            if depth0.ndim == 2:
                depth0 = depth0[..., None]

        # foreground loss mask (nerfstudio `mask_path`): the loss blacks out
        # both gt and pred where mask == 0 (ref: freegaussian_model.py:948-957)
        mask = None
        if p.mask_filenames is not None:
            mp = p.mask_filenames[i]
            if mp is not None and Path(mp).exists():
                mp = Path(mp)
                if mp.suffix == ".npy":
                    mask = np.load(mp)
                else:
                    m = read_png(mp)
                    mask = (m[..., 0] if m.ndim == 3 else m) > 127
                mask = np.squeeze(np.asarray(mask)).astype(bool)

        def make_cam(c2w, t):
            f = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
            return Camera(
                c2w=f(np.asarray(c2w, np.float32)), fx=f(p.fx[i]), fy=f(p.fy[i]), cx=f(p.cx[i]), cy=f(p.cy[i]),
                time=f(t), width=int(image.shape[1]), height=int(image.shape[0]),
            )

        # camera0 shares the frame's intrinsics but carries the paired frame's
        # own time (`times0`, ref: freegaussian_dataparser.py:489-512)
        t0 = p.times0[i] if p.times0 is not None else p.times[max(i - 1, 0)]
        return CachedFrame(
            image=image,
            camera=make_cam(p.c2w[i], p.times[i]),
            camera0=make_cam(p.c2w0[i], t0),
            flow=flow,
            depth0=depth0,
            mask=mask,
            atrb_mask=p.atrb_masks[i] if p.atrb_masks is not None else None,
            mask_valid=p.mask_valids[i] if p.mask_valids is not None else None,
        )

    def __len__(self) -> int:
        return len(self.frames)

    def next_train(self, step: int) -> Tuple[Camera, Dict[str, torch.Tensor]]:
        """Random-without-replacement epoch ordering (nerfstudio
        FullImageDatamanager semantics)."""
        _, cam, batch = self.next_train_indexed(step)
        return cam, batch

    def next_train_indexed(self, step: int) -> Tuple[int, Camera, Dict[str, torch.Tensor]]:
        """Like `next_train` but also returns the frame index (for the
        paired `camera0`)."""
        idx = self.draw_indices(1)[0]
        cam, batch = self.get_batch(idx)
        return idx, cam, batch

    def draw_indices(self, n: int) -> List[int]:
        """The next n frame indices of the epoch permutations."""
        out = []
        for _ in range(n):
            if not self._epoch_order:
                self._epoch_order = list(self.rng.permutation(len(self.frames)))
            out.append(int(self._epoch_order.pop()))
        return out

    def camera0(self, idx: int) -> Camera:
        """Paired (previous) frame's camera for the flow-derivative path."""
        return self.frames[idx].camera0

    def get_batch(self, idx: int) -> Tuple[Camera, Dict[str, torch.Tensor]]:
        """(camera, batch) of frame `idx`; the batch is a fresh dict (callers
        add keys to it) of tensors on the device."""
        if idx in self._device_cache:
            cam, batch = self._device_cache[idx]
            return cam, dict(batch)
        f = self.frames[idx]
        dev = self.device
        image = f.image.astype(np.float32) / 255.0
        batch: Dict[str, torch.Tensor] = {"image": torch.from_numpy(image).to(dev)}
        if f.mask is not None:
            m = f.mask.astype(np.float32).reshape(f.mask.shape[0], f.mask.shape[1], 1)
            batch["mask"] = torch.from_numpy(m).to(dev)
        if f.flow is not None:
            batch["flow"] = torch.from_numpy(f.flow).to(dev)
        if f.depth0 is not None:
            batch["depth0"] = torch.from_numpy(f.depth0).to(dev)
        if f.atrb_mask is not None:
            batch["atrb_mask"] = torch.from_numpy(np.ascontiguousarray(f.atrb_mask)).to(dev)
            batch["mask_valid"] = torch.from_numpy(np.asarray(f.mask_valid)).to(dev)
        self._device_cache[idx] = (f.camera, dict(batch))
        return f.camera, batch

    def eval_frames(self):
        for i in range(len(self.frames)):
            yield self.get_batch(i)
