"""Pinhole camera: a dataclass of tensors (twin of `freegaussian_tpu/data/cameras.py:Camera`).

c2w is camera-to-world in the OpenGL convention; fx, fy, cx, cy and the
normalized frame time are 0-d tensors on the camera's device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.math import get_viewmat


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
        c2w = self.c2w
        if c2w.shape[-2] == 3:
            bottom = torch.zeros_like(c2w[..., :1, :])
            bottom[..., 0, 3] = 1.0
            c2w = torch.cat([c2w, bottom], dim=-2)
        return get_viewmat(c2w[None])[0]

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
        flip = torch.tensor([1.0, -1.0, -1.0], dtype=self.c2w.dtype, device=self.c2w.device)
        return torch.cat([self.c2w[..., :3, :3] * flip, self.c2w[..., :3, 3:4]], dim=-1)

    @property
    def position(self) -> torch.Tensor:
        return self.c2w[..., :3, 3]
