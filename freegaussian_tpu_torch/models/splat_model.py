"""Stage-1 FreeGaussian model: deformable 3DGS forward pass and losses
(twin of `freegaussian_tpu/models/splat_model.py`).

`forward(cfg, params, alive, camera, deform=..., train=...)` renders one
camera the way the JAX package does: the deform warm-up gate, the SE(3)
warp, `rasterization`, the background composite and clamp, and the
detached-max depth backfill. With `train=True` it is differentiable in the
Gaussian parameters and the deform field's weights, takes the background
the train step drew (`background`), passes
the absgrad sink to the compositor, and with `camera0` deforms to the paired
frame's time (`means_prev`) and, with `render_flow`, composites the
per-Gaussian screen motion as two channels before any depth channel. With
`train=False` (serving) it runs under `torch.no_grad`.

`loss_fn` is the masked L1 + SSIM (+ optional scale regularization),
`psnr` the metric, `downscale_factor` the progressive-resolution schedule.
`SplatModel` bundles the parameters, the alive mask and the deform field in
one nn.Module whose state_dict keys are the reference checkpoint's
(`gauss_params.*`, `deform.*`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from ..data.cameras import Camera
from ..ops.math import device_constant, num_sh_bases, safe_norm
from ..ops.projection import project_gaussians
from ..ops.rasterize import rasterization
from .bilagrid import slice_bilateral_grid
from .fields import ControlField, DeformField, apply_se3_deform
from .gaussians import PARAM_NAMES, GaussianParams, colors_from_features
from .ssim import ssim

@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Static model configuration; same fields and defaults as the JAX
    package's SplatConfig, except `deform_impl`. Fields that tune the TPU
    (chunk, capacities, the remat choices) are kept so configs carry over,
    and are not read by the port.

    `deform_impl` picks the field MLPs' implementation, as the JAX package's
    `make_deform_apply` / `make_control_apply` do on the TPU:
      "fused"   (the default here) the bf16 deform field as the kernel pair
                of `ops/mlp_cuda.py` that includes its heads, the port of
                the JAX package's `impl="fused"` Pallas pair; the control
                field runs its f32 split-linear chain;
      "pallas"  the bf16 deform trunk and the control trunk as the kernel
                pair without heads (heads in f32 outside), the port of the
                JAX package's `impl="pallas"` (`fused_deform_trunk`,
                `fused_control_trunk`);
      anything else ("headsfused", "flax", ...) the split-linear chains,
                the twins of the JAX package's "headsfused" / flax paths
                (its default, and its only path off the TPU).
    An f32 deform field (`deform_bf16=False`) always runs the split-linear
    chain, as in the JAX package; the control field does not read
    `deform_bf16`."""

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
    deform_impl: str = "fused"
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


def make_deform_field(cfg: SplatConfig, depth: int = 8, width: int = 256) -> DeformField:
    impl = cfg.deform_impl if cfg.deform_bf16 and cfg.deform_impl in ("fused", "pallas") else "split"
    return DeformField(
        depth=depth,
        width=width,
        is_blender=cfg.is_blender,
        compute_dtype=torch.bfloat16 if cfg.deform_bf16 else torch.float32,
        impl=impl,
    )


def make_control_field(cfg: SplatConfig, depth: int = 8, width: int = 256) -> ControlField:
    """The control field: its trunk on the kernel pair under "pallas", else
    the f32 split-linear chain (the JAX package's "fused" falls through to
    its flax f32 path too)."""
    return ControlField(depth=depth, width=width, impl="pallas" if cfg.deform_impl == "pallas" else "split")


def downscale_factor(cfg: SplatConfig, step: int, train: bool) -> int:
    """Progressive training resolution: 2^max(num_downscales - step // resolution_schedule, 0)."""
    if not train:
        return 1
    return int(2 ** max(cfg.num_downscales - int(step) // cfg.resolution_schedule, 0))


def sh_degree_to_use(cfg: SplatConfig, step: int) -> int:
    return min(step // cfg.sh_degree_interval, cfg.sh_degree)


def background_color(cfg: SplatConfig, device: torch.device) -> torch.Tensor:
    """The serving background ("random" serves the viser default; the train
    step draws its own), a `device_constant`: a captured render copies
    nothing from the host."""
    values = {"random": (0.1490, 0.1647, 0.2157), "white": (1.0, 1.0, 1.0)}.get(cfg.background_color, (0.0, 0.0, 0.0))
    return device_constant(values, torch.float32, device)


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
    background: Optional[torch.Tensor] = None,
    means2d_sink: Optional[torch.Tensor] = None,
    camera0: Optional[Camera] = None,
    render_flow: bool = False,
    bilagrid: Optional[torch.Tensor] = None,
    image_idx: int = 0,
    primitive_shard_axis=None,
    band_origin_y: int = 0,
    band_height: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Render one camera. Returns rgb (H, W, 3), accumulation (H, W, 1),
    background, radii, means2d, depths, num_isects, and as they apply depth
    (H, W, 1), flow (H, W, 2) and means_prev (N, 3). With `bilagrid` (in
    training only) grid `image_idx` corrects the composited rgb.

    The multi-GPU step's arguments: `primitive_shard_axis`, a process
    group of ng ranks, runs the per-Gaussian stage (deform field,
    projection, SH) on this rank's 1/ng slice of the capacity and gathers
    the render attributes over the group into the pixel stage (gradients
    reduce back to the shard); the full-capacity outputs (radii, means2d,
    depths, means_prev) come back gathered. `band_origin_y` and
    `band_height` render rows [origin, origin + band_height) of the
    camera's frame."""
    with contextlib.nullcontext() if train else torch.no_grad():
        out = _forward(
            cfg, params, alive, camera, deform, step, sh_degree_now, warmed_up, train,
            render_mode, background, means2d_sink, camera0, render_flow,
            primitive_shard_axis, band_origin_y, band_height,
        )
        if bilagrid is not None and train:
            # per-image appearance correction after the background and the clip (ref :879-882)
            out["rgb"] = slice_bilateral_grid(bilagrid, image_idx, out["rgb"])
        return out


def _forward(
    cfg, params, alive, camera, deform, step, sh_degree_now, warmed_up, train,
    render_mode, background, means2d_sink, camera0, render_flow,
    shard_group=None, band_origin_y=0, band_height=None,
):
    if shard_group is not None:
        import torch.distributed as dist

        ng, idx = dist.get_world_size(shard_group), dist.get_rank(shard_group)
        cap = params["means"].shape[0]
        if cap % ng:
            raise ValueError(f"capacity {cap} must divide the primitive shard group's {ng} ranks")
        rows = slice(idx * (cap // ng), (idx + 1) * (cap // ng))
        params = {k: v[rows] for k, v in params.items()}
        alive = alive[rows]
        if means2d_sink is not None:
            means2d_sink = means2d_sink[rows]
    means = params["means"]
    scales_lin = torch.exp(params["scales"])
    quats_n = params["quats"] / safe_norm(params["quats"], dim=-1, keepdim=True)
    opacities = torch.sigmoid(params["opacities"][..., 0])
    sh_coeffs = colors_from_features(params)

    if render_mode is None:
        render_mode = "RGB+ED" if (cfg.output_depth_during_training or not train) else "RGB"
    if sh_degree_now is None:
        sh_degree_now = sh_degree_to_use(cfg, step)
    if warmed_up is None:
        warmed_up = step >= cfg.warm_up
    warmed_up = bool(warmed_up)

    # Warm-up gate: before warm-up the canonical Gaussians render as they
    # are and the deform field gets no gradient (the JAX gate multiplies the
    # deltas by 0, which is the same). The field sees detached means.
    if deform is not None and warmed_up:
        times = camera.time.reshape(1, 1)
        d_xyz, d_rot, d_scale = deform(means.detach(), times, live=alive)
        means_d = apply_se3_deform(means, d_xyz)
        scales_d = scales_lin + d_scale
        quats_d = quats_n + d_rot
        # the JAX package's gate arithmetic at gate == 1, for the same rounding
        means = means + (means_d - means)
        scales_lin = scales_lin + (scales_d - scales_lin)
        quats_n = quats_n + (quats_d - quats_n)

    # Flow-derivative path: deform at the paired frame's time, project
    # through the paired camera, composite the per-Gaussian screen motion.
    extra_channels = None
    means_prev = None
    if camera0 is not None and deform is not None:
        base = params["means"]
        if warmed_up:
            d_xyz0, _, _ = deform(base.detach(), camera0.time.reshape(1, 1), live=alive)
            means_prev_d = apply_se3_deform(base, d_xyz0)
            means_prev = base + (means_prev_d - base)
        else:
            means_prev = base
        if render_flow:
            proj_t = project_gaussians(
                means, quats_n, scales_lin, camera.viewmat, camera.K, camera.width, camera.height,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane, alive=alive,
            )
            proj_0 = project_gaussians(
                means_prev, quats_n, scales_lin, camera0.viewmat, camera0.K, camera0.width, camera0.height,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane, alive=alive,
            )
            extra_channels = proj_t.means2d - proj_0.means2d  # (N, 2) screen motion

    if shard_group is not None and means_prev is not None:
        from ..parallel.distributed import all_gather_rows

        means_prev = all_gather_rows(means_prev, shard_group)
    return render_gaussians(
        cfg, means, quats_n, scales_lin, opacities, sh_coeffs, alive, camera,
        sh_degree_now=sh_degree_now, render_mode=render_mode, background=background,
        means2d_sink=means2d_sink, extra_channels=extra_channels, means_prev=means_prev,
        gather_axis=shard_group, band_origin_y=band_origin_y, band_height=band_height,
    )


def render_gaussians(
    cfg: SplatConfig, means, quats_n, scales_lin, opacities, sh_coeffs, alive, camera: Camera, *,
    sh_degree_now: int, render_mode: str, background: Optional[torch.Tensor] = None,
    means2d_sink: Optional[torch.Tensor] = None, extra_channels: Optional[torch.Tensor] = None,
    means_prev: Optional[torch.Tensor] = None,
    gather_axis=None,
    band_origin_y: int = 0,
    band_height: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """`rasterization` of the (deformed) Gaussians, then the background
    composite and clamp and the detached-max depth backfill: the tail that
    the stage-1 and the stage-2 forwards share. The binning's capacity is
    the JAX package's rule (`isect_capacity`)."""
    render, alpha, info = rasterization(
        means,
        quats_n,
        scales_lin,
        opacities,
        sh_coeffs,
        camera.viewmat[None],
        camera.K[None],
        camera.width,
        band_height if band_height is not None else camera.height,
        tile_size=cfg.tile_size,
        near_plane=cfg.near_plane,
        far_plane=cfg.far_plane,
        render_mode=render_mode,
        sh_degree=sh_degree_now,
        rasterize_mode=cfg.rasterize_mode,
        alive=alive,
        means2d_sink=means2d_sink,
        extra_channels=extra_channels,
        backend=cfg.backend,
        chunk=cfg.chunk,
        isect_capacity=isect_capacity(cfg, means.shape[0], gather_axis),
        tight_radius=cfg.tight_radius,
        gather_axis=gather_axis,
        tile_origin_y=band_origin_y,
        proj_height=camera.height if band_height is not None else None,
    )

    bg = background if background is not None else background_color(cfg, means.device)
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
    depth_ch = 3
    if extra_channels is not None:
        # channel layout: [rgb (3), flow (2), depth?]
        out["flow"] = render[0, ..., 3:5]
        depth_ch = 5
    if means_prev is not None:
        out["means_prev"] = means_prev
    if render_mode == "RGB+ED":
        depth = render[0, ..., depth_ch : depth_ch + 1]
        # unseen pixels get the detached max depth (ref: freegaussian_model.py:886)
        out["depth"] = torch.where(alpha[0] > 0, depth, depth.max().detach())
    return out


def isect_capacity(cfg: SplatConfig, num_gaussians: int, gather_axis=None) -> int:
    """The binning's slot capacity (the JAX package's rule,
    splat_model.py:379-383): `cfg.isect_capacity`, else
    `isect_capacity_factor` slots per Gaussian of the whole (gathered) set,
    `num_gaussians` being this rank's shard of it."""
    if cfg.isect_capacity is not None:
        return cfg.isect_capacity
    shard_factor = 1
    if gather_axis is not None:
        import torch.distributed as dist

        shard_factor = dist.get_world_size(gather_axis)
    return cfg.isect_capacity_factor * num_gaussians * shard_factor


def loss_fn(
    cfg: SplatConfig,
    outputs: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    params: GaussianParams,
    alive: torch.Tensor,
    *,
    apply_scale_reg: bool = False,
) -> Dict[str, torch.Tensor]:
    """Masked L1 + SSIM loss (+ optional PhysGaussian scale regularization).
    (ref: freegaussian_model.py:944-990)"""
    gt = batch["image"]
    if gt.shape[-1] == 4:
        a = gt[..., 3:4]
        gt = a * gt[..., :3] + (1 - a) * outputs["background"]
    pred = outputs["rgb"]
    if batch.get("mask") is not None:
        mask = batch["mask"]
        gt = gt * mask
        pred = pred * mask
    l1 = torch.mean(torch.abs(gt - pred))
    simloss = 1.0 - ssim(gt, pred)
    main_loss = (1 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * simloss
    scale_reg = scale_regularization(cfg, params, alive, apply_scale_reg)
    return {"main_loss": main_loss, "scale_reg": scale_reg, "l1": l1, "ssim": 1 - simloss}


def scale_regularization(cfg: SplatConfig, params: GaussianParams, alive: torch.Tensor, apply: bool) -> torch.Tensor:
    """PhysGaussian's scale-ratio regularization, when configured and `apply`."""
    if not (cfg.use_scale_regularization and apply):
        return torch.zeros((), device=alive.device)
    scale_exp = torch.exp(params["scales"])
    ratio = scale_exp.amax(dim=-1) / torch.clamp(scale_exp.amin(dim=-1), min=1e-12)
    reg = torch.clamp(ratio, min=cfg.max_gauss_ratio) - cfg.max_gauss_ratio
    return 0.1 * torch.sum(reg * alive) / torch.clamp(alive.sum(), min=1)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


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

    @torch.no_grad()
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
