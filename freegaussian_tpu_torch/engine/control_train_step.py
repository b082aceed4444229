"""The stage-2 (control) training step (twin of
`freegaussian_tpu/engine/control_train_step.py`).

    step_fn = make_control_train_step(splat_cfg, optimizers, gaussian_mask, init_time)
    state, metrics = step_fn(state, camera, batch, sh_degree_now)

It trains the Gaussian groups and the control field (`state.control`, Adam
group "control"); the deform field (`state.deform`) is frozen and only sets
the control state, and there is no densification (the reference drops the
`deform` group and the densification callbacks for stage 2,
freegaussian_control_model.py:211-218). The loss is the masked L1 + SSIM,
without scale regularization (the JAX step passes no `apply_scale_reg`).
As in the stage-1 step, `state` is updated in place and returned, and the
random background comes from `state.generator` or `draws["background"]`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..data.cameras import Camera
from ..models.control_model import control_forward
from ..models.splat_model import SplatConfig, loss_fn, psnr
from .optimizers import Adam, apply_group_updates
from .train_step import GAUSSIAN_GROUPS, TrainState, draw_background, params_by_group, state_metrics


def make_control_train_step(
    splat_cfg: SplatConfig,
    optimizers: Dict[str, Adam],
    gaussian_mask: torch.Tensor,  # (N, M) bool
    init_time,
    *,
    train_gaussians: bool = True,
):
    """Build the step. Returns step_fn(state, camera, batch, sh_degree_now,
    draws=None) -> (state, metrics), with the JAX step's metric keys. As in
    the stage-1 step (`train_step.make_train_step`), `step_fn.core(state,
    camera, batch, sh_degree_now, draws, scalars=None)` is the part a CUDA
    graph replays (every write in place, Adam's scalars from `scalars` when
    given) and `step_fn.groups(state)` the groups `state_metrics` checks;
    stage 2 has no refinement. The init time lives on the mask's device, so
    the step copies nothing from the host."""
    init_t = torch.as_tensor(init_time, dtype=torch.float32).to(gaussian_mask.device)

    def groups_of(state):
        return params_by_group(state.params, None, state.control)

    def core(state, camera, batch, sh_degree_now, draws, scalars=None):
        params, alive = state.params, state.alive
        dev = alive.device
        bg = draw_background(splat_cfg, dev, state.generator, draws or {})
        outputs = control_forward(
            splat_cfg, params, alive, gaussian_mask, camera, state.control,
            deform=state.deform, init_time=init_t, sh_degree_now=sh_degree_now, train=True, background=bg,
        )
        losses = loss_fn(splat_cfg, outputs, batch, params, alive)
        total = losses["main_loss"] + losses["scale_reg"]

        groups = groups_of(state)
        if not train_gaussians:
            groups = {"control": groups["control"]}
        names = [(g, k) for g, ps in groups.items() for k in ps]
        grads = torch.autograd.grad(total, [groups[g][k] for g, k in names], allow_unused=True)
        grads_by_group = {g: {} for g in groups}
        for (g, k), grad in zip(names, grads):
            if grad is not None and g in GAUSSIAN_GROUPS:
                # dead slots must not move
                grad = torch.where(alive.reshape((-1,) + (1,) * (grad.ndim - 1)), grad, torch.zeros_like(grad))
            grads_by_group[g][k] = grad
        apply_group_updates(optimizers, state.opt_states, groups, grads_by_group, scalars)
        with torch.no_grad():
            return {
                "loss": total.detach(),
                "main_loss": losses["main_loss"].detach(),
                "psnr": psnr(outputs["rgb"].detach(), batch["image"][..., :3]),
                "num_isects": torch.as_tensor(outputs["num_isects"], device=dev),
            }

    def step_fn(
        state: TrainState,
        camera: Camera,
        batch: Dict[str, torch.Tensor],
        sh_degree_now: int,
        draws: Optional[Dict[str, Any]] = None,
    ):
        metrics = core(state, camera, batch, sh_degree_now, draws)
        with torch.no_grad():
            metrics.update(state_metrics(state, groups_of(state)))
        state.step += 1
        return state, metrics

    step_fn.core = core
    step_fn.groups = groups_of
    return step_fn
