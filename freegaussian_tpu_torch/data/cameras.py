"""Pinhole camera: a dataclass of tensors (twin of `freegaussian_tpu/data/cameras.py:Camera`).

c2w is camera-to-world in the OpenGL convention; fx, fy, cx, cy and the
normalized frame time are 0-d tensors on the camera's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.math import get_viewmat, opengl_to_opencv_c2w, to_4x4


@dataclasses.dataclass(frozen=True)
class Camera:
    c2w: torch.Tensor  # (3, 4) or (4, 4) camera-to-world, OpenGL convention
    fx: torch.Tensor  # ()
    fy: torch.Tensor  # ()
    cx: torch.Tensor  # ()
    cy: torch.Tensor  # ()
    time: torch.Tensor  # () normalized frame time in [0, 1]
    width: int = 0
    height: int = 0

    @property
    def K(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            -2,
        )

    @property
    def viewmat(self) -> torch.Tensor:
        """OpenCV world-to-camera (4, 4)."""
        return get_viewmat(to_4x4(self.c2w)[None])[0]

    def downscaled(self, d: int) -> "Camera":
        """Camera for a 1/d resolution render."""
        if d == 1:
            return self
        return dataclasses.replace(
            self,
            fx=self.fx / d,
            fy=self.fy / d,
            cx=self.cx / d,
            cy=self.cy / d,
            width=self.width // d,
            height=self.height // d,
        )

    @property
    def c2w_opencv(self) -> torch.Tensor:
        """(3, 4) camera-to-world in the OpenCV convention (y and z columns flipped)."""
        return opengl_to_opencv_c2w(self.c2w[..., :3, :], keep_original_world_coordinate=True)

    @property
    def position(self) -> torch.Tensor:
        return self.c2w[..., :3, 3]


def orbit_camera_path(cameras, num_frames: int = 60, radius=None, height=None):
    """An orbit camera path around the scene (the `ns-render camera-path`
    analogue, twin of `freegaussian_tpu/data/cameras.py:orbit_camera_path`):
    a circle at the cameras' mean height and mean distance from the y axis,
    looking at the origin, with time sweeping 0 -> 1 across the orbit. The
    cameras keep the first camera's intrinsics and device."""
    ref = cameras[0]
    pos = np.stack([c.position.detach().cpu().numpy() for c in cameras])
    if radius is None:
        radius = float(np.linalg.norm(pos[:, [0, 2]], axis=1).mean())
    if height is None:
        height = float(pos[:, 1].mean())
    dev = ref.c2w.device
    out = []
    for i in range(num_frames):
        ang = 2 * np.pi * i / num_frames
        eye = np.array([radius * np.sin(ang), height, radius * np.cos(ang)], np.float32)
        fwd = -eye / max(np.linalg.norm(eye), 1e-8)
        right = np.cross(np.array([0, 1, 0], np.float32), -fwd)
        right = right / max(np.linalg.norm(right), 1e-8)
        up = np.cross(-fwd, right)
        c2w = np.concatenate([np.stack([right, up, -fwd], axis=-1), eye[:, None]], axis=-1).astype(np.float32)
        out.append(dataclasses.replace(
            ref,
            c2w=torch.from_numpy(c2w).to(dev),
            time=torch.tensor(i / max(num_frames - 1, 1), dtype=torch.float32, device=dev),
        ))
    return out
