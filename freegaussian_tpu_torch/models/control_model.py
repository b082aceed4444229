"""Stage-2 control model (twin of `freegaussian_tpu/models/control_model.py`).

The stage-1 Gaussians and deform field are frozen; a control field maps
(position, 3-vector control state) to per-Gaussian deltas for the Gaussians
that the cluster mask selects (reference freegaussian_control_model.py:23-218):

  - control state (train): each attribute's mean displacement under the
    deform field between the init camera's time and the current time
    (:128-138), without gradient
  - control state (eval): injected attribute vectors (the viewer's sliders,
    an (M, 3) array)
  - per-point state: mask @ d_avg / mask.sum (:140)
  - deltas added on the selected Gaussians only: means += d, scales =
    exp(s) + d, quats = normalize(q) + d (:141-155)

As in the JAX package, the control field runs over the whole padded set and
its deltas are masked, so shapes do not depend on the mask.

`ControlModel` is the serving module: a `SplatModel` (Gaussians, alive,
deform field) with the control field (`control.*` state_dict keys) and the
(N, M) `gaussian_mask` buffer; its forward renders a camera at injected
attribute values.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from ..data.cameras import Camera
from ..ops.math import safe_norm
from .fields import ControlField, DeformField, apply_se3_deform
from .gaussians import GaussianParams, colors_from_features
from .splat_model import SplatConfig, SplatModel, make_control_field, render_gaussians


@torch.no_grad()
def control_state_from_deform(
    deform: DeformField,
    means: torch.Tensor,  # (N, 3) canonical means (the whole padded set)
    gaussian_mask: torch.Tensor,  # (N, M) bool cluster membership
    time0,
    time1,
    *,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each attribute's mean displacement (M, 3) under the deform field
    between time0 and time1 over its cluster (ref :128-138), without
    gradient, as the reference's no_grad block."""
    if alive is not None:
        gaussian_mask = gaussian_mask & alive[:, None]

    def deformed(t):
        t = torch.as_tensor(t, dtype=torch.float32, device=means.device).reshape(1, 1)
        d_xyz, _, _ = deform(means, t, live=alive)
        return apply_se3_deform(means, d_xyz)

    disp = deformed(time1) - deformed(time0)  # (N, 3)
    m = gaussian_mask.to(means.dtype)  # (N, M)
    num = torch.einsum("nm,nc->mc", m, disp)
    den = torch.clamp(m.sum(0), min=1.0)[:, None]
    return num / den


def blend_control_values(gaussian_mask: torch.Tensor, d_avg: torch.Tensor) -> torch.Tensor:
    """Per-point control value = mask @ d_avg / mask.sum(-1) (ref :140);
    points in no cluster get zeros."""
    m = gaussian_mask.to(d_avg.dtype)
    den = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    return (m @ d_avg) / den


def control_forward(
    cfg: SplatConfig,
    params: GaussianParams,
    alive: torch.Tensor,
    gaussian_mask: torch.Tensor,  # (N, M) bool
    camera: Camera,
    control: ControlField,
    *,
    deform: Optional[DeformField] = None,
    init_time=None,
    atrb_values=None,  # (M, 3) eval-mode control state
    sh_degree_now: int = 3,
    train: bool = True,
    background: Optional[torch.Tensor] = None,
    render_mode: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Stage-2 forward. Either `atrb_values` (the eval / viewer path) or
    (`deform`, `init_time`) (the train path) sets the control state. With
    `train=True` it is differentiable in the Gaussian parameters (the
    control field sees the means themselves) and the control field's
    weights, and composites over `background` (the train step draws it);
    with `train=False` it runs under `torch.no_grad`. Returns the stage-1
    forward's keys (rgb, accumulation, background, radii, means2d, depths,
    num_isects, depth with RGB+ED) and control_state (M, 3)."""
    with contextlib.nullcontext() if train else torch.no_grad():
        means = params["means"]
        sel = (gaussian_mask.any(-1) & alive)[:, None].to(means.dtype)
        if atrb_values is None:
            if deform is None or init_time is None:
                raise ValueError("control_forward needs atrb_values, or deform and init_time")
            d_avg = control_state_from_deform(deform, means, gaussian_mask, init_time, camera.time, alive=alive)
        else:
            d_avg = torch.as_tensor(atrb_values, dtype=torch.float32, device=means.device)

        value = blend_control_values(gaussian_mask & alive[:, None], d_avg)
        d_xyz, d_rot, d_scale = control(means, value, live=alive)

        new_means = means + sel * d_xyz
        scales_lin = torch.exp(params["scales"]) + sel * d_scale
        quats_n = params["quats"] / safe_norm(params["quats"], dim=-1, keepdim=True)
        new_quats = quats_n + sel * d_rot
        opacities = torch.sigmoid(params["opacities"][..., 0])
        if render_mode is None:
            render_mode = "RGB" if train else "RGB+ED"
        out = render_gaussians(
            cfg, new_means, new_quats, scales_lin, opacities, colors_from_features(params), alive, camera,
            sh_degree_now=sh_degree_now, render_mode=render_mode, background=background,
        )
        out["control_state"] = d_avg
        return out


class Controller:
    """Holds M attribute 3-vectors, scaled by 0.1 as the reference's viser
    sliders are (freegaussian_controller.py:15-39); the viewer reads each
    request's sliders through it."""

    def __init__(self, num_attributes: int, scale: float = 0.1):
        self.num_attributes = num_attributes
        self.scale = scale
        self._values = np.zeros((num_attributes, 3), np.float32)

    def set_vector3(self, index: int, value) -> None:
        self._values[index] = np.asarray(value, np.float32)

    def get_atrb_vals(self) -> np.ndarray:
        return self._values * self.scale


class ControlModel(SplatModel):
    """Stage-2 model state for serving: the stage-1 `SplatModel` (padded
    Gaussians, alive, deform field) plus the control field and the (N, M)
    bool `gaussian_mask` buffer. State_dict keys: the stage-1 ones,
    `control.<layer>` as in the reference checkpoint, and `gaussian_mask`."""

    def __init__(self, cfg: SplatConfig, capacity: int, num_attributes: int, *, step: int = 0, device="cuda"):
        super().__init__(cfg, capacity, step=step, device=device)
        dev = self.alive.device
        self.control = make_control_field(cfg).to(dev)
        self.register_buffer("gaussian_mask", torch.zeros((capacity, num_attributes), dtype=torch.bool, device=dev))

    @property
    def num_attributes(self) -> int:
        return self.gaussian_mask.shape[1]

    @torch.no_grad()
    def forward(self, camera: Camera, atrb_values=None) -> Dict[str, torch.Tensor]:
        """Render `camera` (RGB+ED) with the attributes at `atrb_values` (M,
        3) (zeros when None), at the full SH degree: the viewer's slider
        render."""
        if atrb_values is None:
            atrb_values = torch.zeros((self.num_attributes, 3), device=self.alive.device)
        return control_forward(
            self.cfg, self.params, self.alive, self.gaussian_mask, camera, self.control,
            atrb_values=atrb_values, sh_degree_now=self.cfg.sh_degree, train=False,
        )
