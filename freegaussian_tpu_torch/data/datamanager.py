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
  - a fixed-order eval loader;
  - a frame with a Brown distortion is undistorted with its foreground
    mask, paired-frame depth, flow and articulation masks, and cropped to
    the valid rectangle (`undistort_frame`, on the datamanager's device;
    OpenCV's arithmetic, `data/undistort.py`);
  - `DeviceArena`: every frame's camera and batch stacked on the device
    (the JAX trainer's `_device_dataset` arena), from which a step selects
    its frame with a device index.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import undistort as ud
from .cameras import Camera
from .dataparsers import ParsedDataset
from .images import read_image


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


def undistort_frame(
    K: np.ndarray,
    distortion: np.ndarray,
    image: np.ndarray,
    mask: Optional[np.ndarray] = None,
    depth: Optional[np.ndarray] = None,
    flow: Optional[np.ndarray] = None,
    atrb_mask: Optional[np.ndarray] = None,
    device="cuda",
):
    """Joint undistortion of a frame's image, foreground mask, depth, flow
    and (H, W, M+1) articulation masks, cropped to the valid rectangle, so
    every per-pixel array stays aligned with its image (twin of
    `freegaussian_tpu/data/datamanager.py:undistort_frame`, which calls
    OpenCV; ref: freegaussian_datamanager.py:239-323). `distortion` is
    (k1, k2, k3, k4, p1, p2) with k4 = 0. Runs on `device` (CUDA unless
    the caller passes the CPU) in float64;
    returns (K' (3, 3) float32, image, mask, depth, flow, atrb_mask) as
    numpy, the same values as the JAX package's:
      - the camera: getOptimalNewCameraMatrix(alpha=0) on K with its
        principal point shifted by -0.5, the ROI's corner subtracted, +0.5;
      - the image: cv2.undistort (bilinear, 0 outside);
      - the masks: undistorted as 0/255 images and thresholded at 127;
      - the depth: a nearest remap through initUndistortRectifyMap;
      - the flow: its start and end points through undistortPoints, re-diffed;
    As in the JAX package, the depth, masks and flow use the camera after
    the ROI's corner was subtracted (the image the one before it)."""
    K = np.array(K, np.float64)
    d = np.asarray(distortion, np.float64)
    if d[3] != 0:
        raise ValueError("the 4th Brown parameter k4 is unsupported (k1, k2, k3, p1, p2 only)")
    dist = [d[0], d[1], d[4], d[5], d[2], d[3], 0.0, 0.0]  # OpenCV's order
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    distorted = any(dist)
    dev = resolve_device(device)
    height, width = image.shape[:2]
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if distorted:
        new_k, (x, y, w, h) = ud.optimal_new_camera_matrix(K, dist, (width, height))
        image_map = ud.fixed_point_map(K, dist, new_k, (width, height), dev)
        image = ud.remap_bilinear_u8(to_dev(image), image_map).cpu().numpy()
    else:
        new_k, (x, y, w, h) = K, (0, 0, width, height)
    image = image[y : y + h, x : x + w]
    new_k = np.array(new_k)
    new_k[0, 2] -= x
    new_k[1, 2] -= y

    # the foreground and articulation masks as channels of one 0/255 image
    planes = ([np.squeeze(mask)] if mask is not None else []) + (
        [atrb_mask[..., c] for c in range(atrb_mask.shape[-1])] if atrb_mask is not None else [])
    if planes:
        m8 = np.stack(planes, axis=-1).astype(np.uint8) * 255
        if distorted:
            mask_map = ud.fixed_point_map(K, dist, new_k, m8.shape[1::-1], dev)
            m8 = ud.remap_bilinear_u8(to_dev(m8), mask_map).cpu().numpy()
        planes = m8[y : y + h, x : x + w] > 127
        if mask is not None:
            mask, planes = planes[..., 0], planes[..., 1:]
        if atrb_mask is not None:
            atrb_mask = planes
    if depth is not None:
        if distorted:
            # nearest, so no depth is invented across an edge (the JAX package's choice)
            depth = np.squeeze(depth, -1) if depth.ndim == 3 and depth.shape[-1] == 1 else depth
            u, v = ud.undistort_map(K, dist, new_k, (depth.shape[1], depth.shape[0]), dev)
            depth = ud.remap_nearest(to_dev(depth.astype(np.float32)), u.float(), v.float()).cpu().numpy()
        depth = depth[y : y + h, x : x + w]
    if flow is not None:
        if distorted:
            fh, fw = flow.shape[:2]
            yg, xg = torch.meshgrid(torch.arange(fh, device=dev), torch.arange(fw, device=dev), indexing="ij")
            start = torch.stack([xg, yg], dim=-1).reshape(-1, 2).double()
            end = start + to_dev(flow).reshape(-1, 2).double()
            und = ud.undistort_points(torch.cat([start, end]), K, dist, new_k)  # both ends in one pass
            flow = (und[start.shape[0]:] - und[: start.shape[0]]).reshape(fh, fw, 2).float().cpu().numpy()
        flow = flow[y : y + h, x : x + w]
    new_k[0, 2] += 0.5
    new_k[1, 2] += 0.5
    return new_k.astype(np.float32), image, mask, depth, flow, atrb_mask


_CAMERA_FIELDS = ("c2w", "fx", "fy", "cx", "cy", "time")


def _stack_cameras(cams: List[Camera]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([getattr(c, k) for c in cams]) for k in _CAMERA_FIELDS}


@dataclasses.dataclass
class DeviceArena:
    """Frames stacked on the device: the camera fields (F, ...), the paired
    cameras' when the flow losses need them, and each batch key (F, ...).
    Built by the trainer from the frames as its per-step path prepares them
    (one downscale phase; zero-filled flow and depth with their validity
    gates, an all-ones mask where any frame has a mask), so a frame selected
    here holds the same values as the per-step path's."""

    cameras: Dict[str, torch.Tensor]
    cameras0: Optional[Dict[str, torch.Tensor]]
    batch: Dict[str, torch.Tensor]
    width: int
    height: int

    @classmethod
    def stack(cls, cams: List[Camera], cams0: Optional[List[Camera]], batches: List[Dict[str, torch.Tensor]]):
        if len({(c.width, c.height) for c in cams}) != 1:
            raise ValueError("the device arena needs frames of one size")
        keys = batches[0].keys()
        if any(b.keys() != keys for b in batches):
            raise ValueError("every frame of the device arena needs the same batch keys")
        return cls(
            cameras=_stack_cameras(cams),
            cameras0=_stack_cameras(cams0) if cams0 is not None else None,
            batch={k: torch.stack([b[k] for b in batches]) for k in keys},
            width=cams[0].width,
            height=cams[0].height,
        )

    def select(self, idx: torch.Tensor) -> Tuple[Camera, Optional[Camera], Dict[str, torch.Tensor]]:
        """(camera, camera0 or None, batch) of frame `idx`, a (1,) int64
        device tensor, selected on the device (no host synchronisation)."""
        pick = lambda t: t.index_select(0, idx)[0]
        cam = lambda f: Camera(**{k: pick(v) for k, v in f.items()}, width=self.width, height=self.height)
        return (
            cam(self.cameras),
            cam(self.cameras0) if self.cameras0 is not None else None,
            {k: pick(v) for k, v in self.batch.items()},
        )


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
        self.parsed = parsed
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self._epoch_order: List[int] = []
        self._device_cache: Dict[int, Tuple[Camera, Dict[str, torch.Tensor]]] = {}
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            self.frames: List[CachedFrame] = list(pool.map(self._load_frame, range(len(parsed))))

    def _load_frame(self, i: int) -> CachedFrame:
        p = self.parsed
        image = read_image(p.image_filenames[i])
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
                    m = read_image(mp)
                    mask = (m[..., 0] if m.ndim == 3 else m) > 127
                mask = np.squeeze(np.asarray(mask)).astype(bool)

        atrb_mask = p.atrb_masks[i] if p.atrb_masks is not None else None
        K = np.array([[p.fx[i], 0, p.cx[i]], [0, p.fy[i], p.cy[i]], [0, 0, 1]], np.float32)
        if p.distortion is not None and np.any(p.distortion[i]):
            K, image, mask, depth0, flow, atrb_mask = undistort_frame(
                K, p.distortion[i], image, mask=mask, depth=depth0, flow=flow, atrb_mask=atrb_mask, device=self.device,
            )
            if depth0 is not None and depth0.ndim == 2:
                depth0 = depth0[..., None]

        def make_cam(c2w, t):
            f = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
            return Camera(
                c2w=f(np.asarray(c2w, np.float32)), fx=f(K[0, 0]), fy=f(K[1, 1]), cx=f(K[0, 2]), cy=f(K[1, 2]),
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
            atrb_mask=atrb_mask,
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
