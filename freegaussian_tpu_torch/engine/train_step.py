"""The stage-1 training step (twin of `freegaussian_tpu/engine/train_step.py`):
forward, loss (L1 + SSIM, the two flow losses), backward through the tile
compositor's backward, per-group Adam, absgrad statistics and in-step
densification.

    step_fn = make_train_step(splat_cfg, densify_cfg, optimizers, num_train_data)
    state, metrics = step_fn(state, camera, batch, sh_degree_now, camera0=...)

PyTorch runs eagerly, so the step updates `state` in place and returns it
(the JAX package returns a new state). Randomness (the random background,
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
from ..models.densify import DensifyConfig, DensifyState, refine, update_stats, zero_moment_rows
from ..models.fields import DeformField
from ..models.gaussians import GaussianParams
from ..models.splat_model import SplatConfig, background_color, forward, loss_fn, psnr
from ..ops.flow import flow_supervision_loss, query_3d_gaussian_flow, rendered_flow_loss
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


def params_by_group(params: GaussianParams, deform: Optional[DeformField]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer groups: one per Gaussian attribute, plus "deform" with
    the field's weights by state_dict name."""
    groups = {k: {k: params[k]} for k in GAUSSIAN_GROUPS}
    if deform is not None:
        groups["deform"] = dict(deform.named_parameters())
    return groups


def create_train_state(
    params: GaussianParams,
    alive: torch.Tensor,
    deform: Optional[DeformField],
    optimizers: Dict[str, Adam],
    *,
    generator: torch.Generator,
    step: int = 0,
) -> TrainState:
    """A fresh state: zero Adam moments and densification statistics."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return TrainState(
        params=params,
        alive=alive.clone(),
        deform=deform,
        opt_states=init_opt_states(optimizers, params_by_group(params, deform)),
        densify=DensifyState.create(alive.shape[0], device=alive.device),
        step=step,
        generator=generator,
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
    camera0=None, draws=None) -> (state, metrics). Camera optimization and
    the bilateral grid are not ported yet and raise."""
    if train_camera_opt or splat_cfg.camera_optimizer_mode != "off":
        raise NotImplementedError("camera optimization is not ported yet (camera_optimizer_mode must be 'off')")
    if splat_cfg.use_bilateral_grid:
        raise NotImplementedError("the bilateral grid is not ported yet (use_bilateral_grid must be False)")
    use_flow = splat_cfg.flow_loss_weight > 0 or splat_cfg.flow_3d_loss_weight > 0

    def step_fn(
        state: TrainState,
        camera: Camera,
        batch: Dict[str, torch.Tensor],
        sh_degree_now: int,
        camera0: Optional[Camera] = None,
        draws: Optional[Dict[str, Any]] = None,
    ):
        draws = draws or {}
        params, alive = state.params, state.alive
        dev = alive.device
        capacity = alive.shape[0]
        warmed_up = state.step >= splat_cfg.warm_up
        last_size = (camera.height, camera.width)
        flow_active = use_flow and camera0 is not None and "flow" in batch
        deform = state.deform if train_deform else None

        bg = draw_background(splat_cfg, dev, state.generator, draws)
        sink = torch.zeros((capacity, 2), device=dev, requires_grad=True)
        outputs = forward(
            splat_cfg, params, alive, camera,
            deform=deform, sh_degree_now=sh_degree_now, warmed_up=warmed_up, train=True,
            background=bg, means2d_sink=sink,
            camera0=camera0 if flow_active else None,
            render_flow=flow_active and splat_cfg.flow_loss_weight > 0,
        )
        losses = loss_fn(splat_cfg, outputs, batch, params, alive, apply_scale_reg=(state.step % 10 == 0))
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

        groups = params_by_group(params, deform)
        names = [(g, k) for g, ps in groups.items() for k in ps]
        leaves = [groups[g][k] for g, k in names]
        grads = torch.autograd.grad(total, leaves + [sink], allow_unused=True)
        absgrad = grads[-1] if grads[-1] is not None else torch.zeros_like(sink)
        grads_by_group = {g: {} for g in groups}
        for (g, k), grad in zip(names, grads[:-1]):
            if grad is not None and g in GAUSSIAN_GROUPS:
                # dead slots must not move
                grad = torch.where(alive.reshape((-1,) + (1,) * (grad.ndim - 1)), grad, torch.zeros_like(grad))
            grads_by_group[g][k] = grad
        apply_group_updates(optimizers, state.opt_states, groups, grads_by_group)

        # densification bookkeeping (the reference's AFTER_TRAIN_ITERATION callbacks)
        with torch.no_grad():
            dstate = update_stats(state.densify, outputs["radii"], absgrad.detach(), last_size)
            refine_info = None
            if state.step >= densify_cfg.refine_start and state.step % densify_cfg.refine_every == 0:
                new_params, new_alive, dstate, refine_info = refine(
                    densify_cfg, params, alive, dstate, state.step, last_size, num_train_data,
                    generator=state.generator, split_eps=draws.get("split_eps"),
                )
                for k in GAUSSIAN_GROUPS:
                    params[k].copy_(new_params[k])
                    zero_moment_rows(state.opt_states[k], refine_info["moment_zero_mask"], params[k])
                alive = new_alive
                if refine_info["reset_opacity_moments"]:
                    st = state.opt_states["opacities"]
                    st.mu = {k: torch.zeros_like(v) for k, v in st.mu.items()}
                    st.nu = {k: torch.zeros_like(v) for k, v in st.nu.items()}

            # a NaN state renders as pure background with a finite loss (NaN
            # projections cull to radii 0), so check the parameters themselves
            finite = torch.ones((), dtype=torch.bool, device=dev)
            for ps in params_by_group(params, deform).values():
                for v in ps.values():
                    finite &= torch.isfinite(v).all()
            metrics = {
                "params_finite": finite,
                "loss": total.detach(),
                "main_loss": losses["main_loss"].detach(),
                "l1": losses["l1"].detach(),
                "ssim": losses["ssim"].detach(),
                "psnr": psnr(outputs["rgb"].detach(), batch["image"][..., :3]),
                "gaussian_count": alive.sum(),
                "num_isects": outputs["num_isects"],
            }
            for extra_key in ("flow_2d", "flow_3d"):
                if extra_key in losses:
                    metrics[extra_key] = losses[extra_key].detach()
            if refine_info is not None:
                metrics["refine"] = {
                    k: refine_info[k] for k in ("num_split", "num_dup", "num_culled", "num_alive")
                }

        state.alive = alive
        state.densify = dstate
        state.step += 1
        return state, metrics

    return step_fn
