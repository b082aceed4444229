"""The stage-1 training step (twin of `freegaussian_tpu/engine/train_step.py`):
forward, loss (L1 + SSIM, the two flow losses), backward through the tile
compositor's backward, per-group Adam, absgrad statistics and in-step
densification.

    step_fn = make_train_step(splat_cfg, densify_cfg, optimizers, num_train_data)
    state, metrics = step_fn(state, camera, batch, sh_degree_now, camera0=...)

PyTorch runs eagerly, so the step updates `state` in place and returns it
(the JAX package returns a new state): every tensor of the state keeps its
storage from step to step, which is what lets the chunked trainer replay
the step as a CUDA graph (`engine/trainer.py`). Randomness (the random background,
the split samples) comes from `state.generator`; a caller may pass the
draws instead (`draws={"background": (3,), "split_eps": (eps1, eps2)}`),
which is how the parity tests hand both packages the same numbers. The
effective 2D-flow weight takes its resolution from the camera
(`flow_px_ref / max(height, width)`), the one source both the single-GPU
and any later multi-GPU step can share.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..data.cameras import Camera
from ..models.bilagrid import total_variation_loss
from ..models.camera_opt import apply_camera_opt, camera_opt_reg_loss
from ..models.densify import DensifyConfig, DensifyState, refine, update_stats, zero_moment_rows
from ..models.fields import ControlField, DeformField
from ..models.gaussians import GaussianParams
from ..models.splat_model import SplatConfig, background_color, forward, loss_fn, psnr
from ..ops.flow import flow_supervision_loss, query_3d_gaussian_flow, rendered_flow_loss
from ..utils import profiling
from .optimizers import Adam, AdamState, apply_group_updates, init_opt_states

GAUSSIAN_GROUPS = ("means", "scales", "quats", "features_dc", "features_rest", "opacities")


@dataclasses.dataclass
class TrainState:
    params: GaussianParams  # padded (capacity, ...) leaf tensors
    alive: torch.Tensor  # (capacity,) bool
    deform: Optional[DeformField]
    opt_states: Dict[str, AdamState]
    densify: DensifyState
    step: int
    generator: torch.Generator
    control: Optional[ControlField] = None  # stage 2
    camera_opt: Optional[torch.Tensor] = None  # (num_cameras, 6) SO3xR3 tangents when enabled
    bilagrid: Optional[torch.Tensor] = None  # (num_images, W, Y, X, 12) grids when enabled


def params_by_group(
    params: GaussianParams,
    deform: Optional[DeformField],
    control: Optional[ControlField] = None,
    *,
    camera_opt: Optional[torch.Tensor] = None,
    bilagrid: Optional[torch.Tensor] = None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer groups: one per Gaussian attribute, plus "deform" and
    "control" with each field's weights by state_dict name, and
    "camera_opt" / "bilateral_grid" when those tensors are given."""
    groups = {k: {k: params[k]} for k in GAUSSIAN_GROUPS}
    for name, field in (("deform", deform), ("control", control)):
        if field is not None:
            groups[name] = dict(field.named_parameters())
    for name, t in (("camera_opt", camera_opt), ("bilateral_grid", bilagrid)):
        if t is not None:
            groups[name] = {name: t}
    return groups


def create_train_state(
    params: GaussianParams,
    alive: torch.Tensor,
    deform: Optional[DeformField],
    optimizers: Dict[str, Adam],
    *,
    generator: torch.Generator,
    step: int = 0,
    control: Optional[ControlField] = None,
    camera_opt: Optional[torch.Tensor] = None,
    bilagrid: Optional[torch.Tensor] = None,
) -> TrainState:
    """A fresh state: zero Adam moments and densification statistics. With
    `control` (stage 2) the deform field is frozen: it gets no Adam group.
    `camera_opt` and `bilagrid` (stage 1) get their groups."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    extras = {
        k: v.detach().clone().requires_grad_(True) if v is not None else None
        for k, v in (("camera_opt", camera_opt), ("bilagrid", bilagrid))
    }
    if control is not None:
        groups = params_by_group(params, None, control)
    else:
        groups = params_by_group(params, deform, **extras)
    return TrainState(
        params=params,
        alive=alive.clone(),
        deform=deform,
        opt_states=init_opt_states(optimizers, groups),
        densify=DensifyState.create(alive.shape[0], device=alive.device),
        step=step,
        generator=generator,
        control=control,
        **extras,
    )


def draw_background(
    cfg: SplatConfig, device: torch.device, generator: torch.Generator, draws: Dict[str, Any]
) -> torch.Tensor:
    """The step's background: for "random", U(0, 1)^3 from `generator`
    (or the injected `draws["background"]`); else the fixed color."""
    if cfg.background_color != "random":
        return background_color(cfg, device)
    if "background" in draws:
        return draws["background"].to(device)
    return torch.rand(3, generator=generator, device=generator.device).to(device)


def state_metrics(state: TrainState, groups) -> Dict[str, torch.Tensor]:
    """The metrics read off the state after the step (and its refinement):
    params_finite and gaussian_count. A NaN state renders as pure background
    with a finite loss (NaN projections cull to radii 0), so the parameters
    themselves are checked."""
    finite = torch.ones((), dtype=torch.bool, device=state.alive.device)
    for ps in groups.values():
        for v in ps.values():
            finite &= torch.isfinite(v).all()
    return {"params_finite": finite, "gaussian_count": state.alive.sum()}


def make_train_step(
    splat_cfg: SplatConfig,
    densify_cfg: DensifyConfig,
    optimizers: Dict[str, Adam],
    num_train_data: int,
    *,
    train_deform: bool = True,
    train_camera_opt: bool = False,
):
    """Build the step. Returns step_fn(state, camera, batch, sh_degree_now,
    camera0=None, draws=None, cam_idx=0) -> (state, metrics). With camera
    optimization (`train_camera_opt` or a `camera_optimizer_mode` other than
    "off") the state's `camera_opt` row `cam_idx` adjusts the camera before
    the forward; with `use_bilateral_grid` the state's grid `cam_idx`
    corrects the rendered image. Each adds its regularizer to the loss and
    its Adam group, and is skipped when the state does not carry it.

    The step is three parts, which `step_fn` runs in order and the chunked
    trainer (`engine/trainer.py`) runs as a CUDA graph and an eager tail:
      - `step_fn.core(state, camera, batch, sh_degree_now, camera0, draws,
        cam_idx, warmed_up=, apply_scale_reg=, scalars=None)`: forward,
        loss, backward, Adam and the absgrad statistics, every write in
        place; returns the loss metrics. Its host-side inputs are the two
        flags, which the graph burns in (one graph per variant), and Adam's
        scalars, which a graph reads from `scalars`, a device row per group
        (`optimizers.adam_scalars`). `cam_idx` may be a (1,) device tensor.
      - `step_fn.refine(state, step, last_size, draws)`: the refinement at
        its cadence steps (eager: it reads counts on the host), writing the
        parameters, alive mask, moments and statistics in place; returns the
        refine metrics or None.
      - `step_fn.groups(state)`: the parameter groups `state_metrics`
        checks.

    `core` marks where the loss, the backward, the optimizer and the
    bookkeeping begin (`utils/profiling.py:mark`); its caller marks the
    forward's start and the step's end (`step_fn` around its three parts,
    the chunk runner around its graphed body). A mark touches no data."""
    train_camera_opt = train_camera_opt or splat_cfg.camera_optimizer_mode != "off"
    use_bilagrid = splat_cfg.use_bilateral_grid
    use_flow = splat_cfg.flow_loss_weight > 0 or splat_cfg.flow_3d_loss_weight > 0

    def groups_of(state):
        """The groups whose finiteness `state_metrics` checks: the Gaussians
        and the trained deform field."""
        return params_by_group(state.params, state.deform if train_deform else None)

    def core(state, camera, batch, sh_degree_now, camera0, draws, cam_idx, *, warmed_up, apply_scale_reg,
             scalars=None):
        params, alive = state.params, state.alive
        dev = alive.device
        capacity = alive.shape[0]
        last_size = (camera.height, camera.width)
        flow_active = use_flow and camera0 is not None and "flow" in batch
        deform = state.deform if train_deform else None
        cam_adjust = state.camera_opt if train_camera_opt else None
        grids = state.bilagrid if use_bilagrid else None

        bg = draw_background(splat_cfg, dev, state.generator, draws)
        sink = torch.zeros((capacity, 2), device=dev, requires_grad=True)
        outputs = forward(
            splat_cfg, params, alive,
            apply_camera_opt(cam_adjust, camera, cam_idx) if cam_adjust is not None else camera,
            deform=deform, sh_degree_now=sh_degree_now, warmed_up=warmed_up, train=True,
            background=bg, means2d_sink=sink,
            camera0=camera0 if flow_active else None,
            render_flow=flow_active and splat_cfg.flow_loss_weight > 0,
            bilagrid=grids, image_idx=cam_idx,
        )
        profiling.mark("loss", dev)
        losses = loss_fn(splat_cfg, outputs, batch, params, alive, apply_scale_reg=apply_scale_reg)
        total = losses["main_loss"] + losses["scale_reg"]
        if flow_active:
            # flow_valid / depth0_valid: 0/1 gates for frames lacking flow or depth
            gate = float(warmed_up) * torch.as_tensor(batch.get("flow_valid", 1.0), dtype=torch.float32, device=dev)
            if splat_cfg.flow_loss_weight > 0:
                fl = rendered_flow_loss(outputs["flow"], batch["flow"], outputs["accumulation"])
                losses["flow_2d"] = fl
                w2d = splat_cfg.flow_loss_weight
                if splat_cfg.flow_px_ref > 0:
                    # pixel-unit L1 -> resolution-invariant effective weight
                    w2d = w2d * splat_cfg.flow_px_ref / max(camera.height, camera.width)
                total = total + gate * w2d * fl
            if splat_cfg.flow_3d_loss_weight > 0 and "depth0" in batch:
                gate = gate * torch.as_tensor(batch.get("depth0_valid", 1.0), dtype=torch.float32, device=dev)
                lifted = query_3d_gaussian_flow(
                    outputs["means2d"].detach(), batch["depth0"], batch["flow"], camera0.c2w_opencv, camera.K,
                    valid=alive,
                )
                fl3 = flow_supervision_loss(outputs["means_prev"], lifted, outputs["radii"], alive=alive)
                losses["flow_3d"] = fl3
                total = total + gate * splat_cfg.flow_3d_loss_weight * fl3
        if cam_adjust is not None:
            total = total + camera_opt_reg_loss(cam_adjust)
        if grids is not None:
            total = total + 10.0 * total_variation_loss(grids)  # the reference's weight (freegaussian_model.py:989)
        profiling.mark("backward", dev)

        groups = params_by_group(params, deform, camera_opt=cam_adjust, bilagrid=grids)
        names = [(g, k) for g, ps in groups.items() for k in ps]
        leaves = [groups[g][k] for g, k in names]
        grads = torch.autograd.grad(total, leaves + [sink], allow_unused=True)
        profiling.mark("optimizer", dev)
        absgrad = grads[-1] if grads[-1] is not None else torch.zeros_like(sink)
        grads_by_group = {g: {} for g in groups}
        for (g, k), grad in zip(names, grads[:-1]):
            grads_by_group[g][k] = grad
        # dead slots must not move: the update masks the Gaussian groups' gradients by `alive`
        apply_group_updates(
            optimizers, state.opt_states, groups, grads_by_group, scalars, alive=alive, masked=GAUSSIAN_GROUPS
        )
        profiling.mark("bookkeeping", dev)

        # densification bookkeeping (the reference's AFTER_TRAIN_ITERATION callbacks)
        with torch.no_grad():
            update_stats(state.densify, outputs["radii"], absgrad.detach(), last_size)
            metrics = {
                "loss": total.detach(),
                "main_loss": losses["main_loss"].detach(),
                "l1": losses["l1"].detach(),
                "ssim": losses["ssim"].detach(),
                "psnr": psnr(outputs["rgb"].detach(), batch["image"][..., :3]),
                "num_isects": torch.as_tensor(outputs["num_isects"], device=dev),
            }
            for extra_key in ("flow_2d", "flow_3d"):
                if extra_key in losses:
                    metrics[extra_key] = losses[extra_key].detach()
        return metrics

    @torch.no_grad()
    def refine_at(state, step: int, last_size, draws):
        if not (step >= densify_cfg.refine_start and step % densify_cfg.refine_every == 0):
            return None
        with profiling.profile_section("refine", step=step):
            params = state.params
            new_params, new_alive, _, refine_info = refine(
                densify_cfg, params, state.alive, state.densify, step, last_size, num_train_data,
                generator=state.generator, split_eps=draws.get("split_eps"),
            )
            for k in GAUSSIAN_GROUPS:
                params[k].copy_(new_params[k])
                zero_moment_rows(state.opt_states[k], refine_info["moment_zero_mask"], params[k])
            state.alive.copy_(new_alive)
            state.densify.reset_()
            if refine_info["reset_opacity_moments"]:
                st = state.opt_states["opacities"]
                for moments in (st.mu, st.nu):
                    for v in moments.values():
                        v.zero_()
            return {k: refine_info[k] for k in ("num_split", "num_dup", "num_culled", "num_alive")}

    def step_fn(
        state: TrainState,
        camera: Camera,
        batch: Dict[str, torch.Tensor],
        sh_degree_now: int,
        camera0: Optional[Camera] = None,
        draws: Optional[Dict[str, Any]] = None,
        cam_idx: int = 0,
    ):
        draws = draws or {}
        profiling.mark("forward", state.alive.device)
        metrics = core(
            state, camera, batch, sh_degree_now, camera0, draws, cam_idx,
            warmed_up=state.step >= splat_cfg.warm_up, apply_scale_reg=state.step % 10 == 0,
        )
        refined = refine_at(state, state.step, (camera.height, camera.width), draws)
        with torch.no_grad():
            metrics.update(state_metrics(state, groups_of(state)))
        profiling.mark(profiling.END, state.alive.device)
        if refined is not None:
            metrics["refine"] = refined
        state.step += 1
        return state, metrics

    step_fn.core = core
    step_fn.refine = refine_at
    step_fn.groups = groups_of
    return step_fn
