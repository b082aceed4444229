"""Stage-1 FreeGaussian model, inference forward (twin of `freegaussian_tpu/models/splat_model.py`).

`forward(cfg, params, alive, camera, deform=..., train=False)` renders one
camera the way the JAX package serves it: the deform warm-up gate, the
SE(3) warp, `rasterization` in RGB+ED, the background composite and clamp,
and the detached-max depth backfill. `SplatModel` bundles the parameters,
the alive mask and the deform field in one nn.Module whose state_dict keys
are the reference checkpoint's (`gauss_params.*`, `deform.*`).

Training (`train=True`: random backgrounds, the absgrad sink, the flow
channels, losses) comes with the port's training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..data.cameras import Camera
from ..ops.math import num_sh_bases, safe_norm
from ..ops.rasterize import rasterization
from .fields import DeformField, apply_se3_deform
from .gaussians import PARAM_NAMES, GaussianParams, colors_from_features


@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Static model configuration; same fields and defaults as the JAX
    package's SplatConfig. Fields that tune the TPU (chunk, capacities, the
    deform_impl / remat choices) are kept so configs carry over, and are not
    read by the port."""

    warm_up: int = 3000
    num_downscales: int = 2
    resolution_schedule: int = 3000
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    ssim_lambda: float = 0.2
    rasterize_mode: str = "classic"  # or "antialiased"
    background_color: str = "random"  # random | black | white
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    camera_optimizer_mode: str = "off"
    use_bilateral_grid: bool = False
    deform_bf16: bool = True
    deform_remat: bool = False
    deform_impl: str = "headsfused"
    deform_remat_policy: str = ""
    near_plane: float = 0.01
    far_plane: float = 1e10
    tile_size: int = 32
    output_depth_during_training: bool = False
    backend: str = "auto"
    is_blender: bool = True
    flow_loss_weight: float = 0.0
    flow_3d_loss_weight: float = 0.0
    flow_px_ref: float = 0.0
    deform_head_init_scale: float = 1.0
    chunk: int = 128
    isect_capacity_factor: int = 6
    isect_capacity: Optional[int] = None
    tight_radius: bool = True


def make_deform_field(cfg: SplatConfig) -> DeformField:
    return DeformField(
        is_blender=cfg.is_blender,
        compute_dtype=torch.bfloat16 if cfg.deform_bf16 else torch.float32,
    )


def sh_degree_to_use(cfg: SplatConfig, step: int) -> int:
    return min(step // cfg.sh_degree_interval, cfg.sh_degree)


def background_color(cfg: SplatConfig, device: torch.device) -> torch.Tensor:
    """The inference background ("random" serves the viser default)."""
    if cfg.background_color == "random":
        return torch.tensor([0.1490, 0.1647, 0.2157], device=device)
    if cfg.background_color == "white":
        return torch.ones(3, device=device)
    return torch.zeros(3, device=device)


@torch.no_grad()
def forward(
    cfg: SplatConfig,
    params: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    *,
    deform: Optional[DeformField] = None,
    step: int = 0,
    sh_degree_now: Optional[int] = None,
    warmed_up: Optional[bool] = None,
    train: bool = False,
    render_mode: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """Render one camera (inference). Returns rgb (H, W, 3), accumulation
    (H, W, 1), background, radii, means2d, depths, num_isects and, for
    RGB+ED, depth (H, W, 1)."""
    if train:
        raise NotImplementedError("forward(train=True) comes with the stage-1 training slice of the port")
    means = params["means"]
    scales_lin = torch.exp(params["scales"])
    quats = params["quats"]
    quats_n = quats / safe_norm(quats, dim=-1, keepdim=True)
    opacities = torch.sigmoid(params["opacities"][..., 0])
    sh_coeffs = colors_from_features(params)

    if render_mode is None:
        render_mode = "RGB+ED"
    if sh_degree_now is None:
        sh_degree_now = sh_degree_to_use(cfg, step)
    if warmed_up is None:
        warmed_up = step >= cfg.warm_up

    # Warm-up gate: before warm-up the canonical Gaussians render as they
    # are (the JAX gate multiplies the deltas by 0, which is the same).
    if deform is not None and warmed_up:
        times = camera.time.reshape(1, 1)
        d_xyz, d_rot, d_scale = deform(means, times)
        means_d = apply_se3_deform(means, d_xyz)
        scales_d = scales_lin + d_scale
        quats_d = quats_n + d_rot
        # the JAX package's gate arithmetic at gate == 1, for the same rounding
        means = means + (means_d - means)
        scales_lin = scales_lin + (scales_d - scales_lin)
        quats_n = quats_n + (quats_d - quats_n)

    render, alpha, info = rasterization(
        means,
        quats_n,
        scales_lin,
        opacities,
        sh_coeffs,
        camera.viewmat[None],
        camera.K[None],
        camera.width,
        camera.height,
        tile_size=cfg.tile_size,
        near_plane=cfg.near_plane,
        far_plane=cfg.far_plane,
        render_mode=render_mode,
        sh_degree=sh_degree_now,
        rasterize_mode=cfg.rasterize_mode,
        alive=alive,
        backend=cfg.backend,
        tight_radius=cfg.tight_radius,
    )

    bg = background_color(cfg, means.device)
    rgb = torch.clamp(render[0, ..., :3] + (1.0 - alpha[0]) * bg, 0.0, 1.0)
    out = {
        "rgb": rgb,
        "accumulation": alpha[0],
        "background": bg,
        "radii": info.radii,
        "means2d": info.means2d,
        "depths": info.depths,
        "num_isects": info.num_isects,
    }
    if render_mode == "RGB+ED":
        depth = render[0, ..., 3:4]
        # unseen pixels get the max depth (ref: freegaussian_model.py:886)
        out["depth"] = torch.where(alpha[0] > 0, depth, depth.max())
    return out


class SplatModel(nn.Module):
    """Stage-1 model state for serving: padded Gaussian parameters, the alive
    mask and the deform field. Its state_dict keys follow the reference
    checkpoint (`gauss_params.<name>`, `deform.<layer>`), with features_rest
    flat (N, (K-1)*3) as the JAX package keeps it."""

    def __init__(self, cfg: SplatConfig, capacity: int, *, step: int = 0, device="cuda"):
        super().__init__()
        from ..device import resolve_device

        dev = resolve_device(device)
        self.cfg = cfg
        self.step = step
        k = num_sh_bases(cfg.sh_degree)
        shapes = {
            "means": (capacity, 3),
            "scales": (capacity, 3),
            "quats": (capacity, 4),
            "features_dc": (capacity, 3),
            "features_rest": (capacity, (k - 1) * 3),
            "opacities": (capacity, 1),
        }
        self.gauss_params = nn.ParameterDict(
            {n: nn.Parameter(torch.zeros(shapes[n], device=dev), requires_grad=False) for n in PARAM_NAMES}
        )
        self.register_buffer("alive", torch.zeros(capacity, dtype=torch.bool, device=dev))
        self.deform = make_deform_field(cfg).to(dev)

    @property
    def params(self) -> GaussianParams:
        return dict(self.gauss_params.items())

    def forward(
        self, camera: Camera, *, sh_degree_now: Optional[int] = None,
        warmed_up: Optional[bool] = None, render_mode: Optional[str] = None,
    ) -> Dict[str, torch.Tensor]:
        """Inference render at the model's step (the trainer's serving call:
        full SH degree, warm-up gate from the step)."""
        return forward(
            self.cfg, self.params, self.alive, camera,
            deform=self.deform, step=self.step,
            sh_degree_now=self.cfg.sh_degree if sh_degree_now is None else sh_degree_now,
            warmed_up=warmed_up, train=False, render_mode=render_mode,
        )
