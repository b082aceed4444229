"""Per-group Adam with the reference's learning rates and schedules (twin of
`freegaussian_tpu/engine/optimizers.py`).

Each group's update is optax's `adam(lr, b1=0.9, b2=0.999, eps=1e-15)`,
operation for operation:

  mu  = (1 - b1) g + b1 mu
  nu  = (1 - b2) g^2 + b2 nu
  count += 1
  p  += -lr(count - 1) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

with the schedule read at the count before the increment, as optax's
`scale_by_schedule` reads it. A group's parameters are a dict of tensors
(one entry for a Gaussian group, one per weight for the deform field); the
update runs in place under `torch.no_grad`, parameters and moments alike
(the JAX package returns new arrays), so a CUDA graph of a step reads and
writes the same tensors on every replay. `count` is per group and is not
touched when moment rows are zeroed (densification), as in optax.

The step's scalars, -lr(count - 1), 1 / (1 - b1^count) and
1 / (1 - b2^count), are f32 values computed on the host (`adam_scalars`).
The eager update applies them as Python scalars; a CUDA graph, in which a
Python scalar would be a constant, reads the same f32 values from a device
table row (`scalars`), and both multiply by them, so the two updates agree
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.math import exponential_decay_schedule

ADAM_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class OptimizersConfig:
    max_steps: int = 30000
    spatial_lr_scale: float = 1.0
    means_lr: float = 1.6e-4
    means_lr_final: float = 1.6e-6
    features_dc_lr: float = 2.5e-3
    features_rest_lr: float = 2.5e-3 / 20
    opacities_lr: float = 0.05
    scales_lr: float = 5e-3
    quats_lr: float = 1e-3
    camera_opt_lr: float = 1e-4
    camera_opt_lr_final: float = 5e-7
    camera_opt_warmup: int = 1000
    deform_lr: float = 1.6e-4
    deform_lr_final: float = 1.6e-6
    control_lr: float = 1.6e-4
    control_lr_final: float = 1.6e-6
    bilateral_grid_lr: float = 5e-3
    bilateral_grid_lr_final: float = 1e-4
    control_max_steps: int = 15000


@dataclasses.dataclass(frozen=True)
class Adam:
    """One group's optimizer: a constant or scheduled rate and Adam's constants."""

    lr: Union[float, Callable[[int], torch.Tensor]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = ADAM_EPS

    def rate(self, count: int):
        return self.lr(count) if callable(self.lr) else self.lr


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def make_optimizers(cfg: OptimizersConfig) -> Dict[str, Adam]:
    """Per-group optimizers. The 5x on means/deform/control mirrors the
    reference config's `1.6e-4 * 5`, with spatial_lr_scale folded in."""
    s = cfg.spatial_lr_scale
    return {
        "means": Adam(exponential_decay_schedule(cfg.means_lr * 5 * s, cfg.means_lr_final * 5 * s, cfg.max_steps)),
        "features_dc": Adam(cfg.features_dc_lr),
        "features_rest": Adam(cfg.features_rest_lr),
        "opacities": Adam(cfg.opacities_lr),
        "scales": Adam(cfg.scales_lr),
        "quats": Adam(cfg.quats_lr),
        "camera_opt": Adam(
            exponential_decay_schedule(
                cfg.camera_opt_lr, cfg.camera_opt_lr_final, cfg.max_steps,
                warmup_steps=cfg.camera_opt_warmup, lr_pre_warmup=1e-12,
            )
        ),
        "deform": Adam(exponential_decay_schedule(cfg.deform_lr * 5 * s, cfg.deform_lr_final * s, cfg.max_steps)),
        "control": Adam(
            exponential_decay_schedule(cfg.control_lr * 5 * s, cfg.control_lr_final * s, cfg.control_max_steps)
        ),
        "bilateral_grid": Adam(
            exponential_decay_schedule(cfg.bilateral_grid_lr, cfg.bilateral_grid_lr_final, cfg.max_steps)
        ),
    }


def init_adam_state(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def init_opt_states(optimizers: Dict[str, Adam], params_by_group: Dict[str, Dict[str, torch.Tensor]]):
    return {name: init_adam_state(p) for name, p in params_by_group.items() if name in optimizers}


def adam_scalars(opt: Adam, count: int) -> Tuple[float, float, float]:
    """The update's scalars at the group's `count` (before the increment):
    (-lr(count), 1 / (1 - b1^(count + 1)), 1 / (1 - b2^(count + 1))), each
    an f32 value: the schedule's own f32 rate, the bias corrections in
    Python doubles rounded to f32 and then inverted in f32."""
    f32 = np.float32
    count1 = count + 1
    bc1 = f32(1 - opt.b1**count1)
    bc2 = f32(1 - opt.b2**count1)
    return float(-f32(float(opt.rate(count)))), float(f32(1) / bc1), float(f32(1) / bc2)


@torch.no_grad()
def adam_update(
    opt: Adam,
    state: AdamState,
    params: Dict[str, torch.Tensor],
    grads: Dict[str, Optional[torch.Tensor]],
    scalars: Optional[torch.Tensor] = None,
) -> None:
    """One Adam step of a group, in place on `params` and `state`. A missing
    gradient (None) counts as zeros, as JAX's gradient of an unused input.
    `scalars`: a (3,) f32 device row holding `adam_scalars(opt,
    state.count)`, read in place of the host's (a CUDA graph's table)."""
    if scalars is None:
        neg_lr, inv_bc1, inv_bc2 = adam_scalars(opt, state.count)
    else:
        neg_lr, inv_bc1, inv_bc2 = scalars[0], scalars[1], scalars[2]
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            g = torch.zeros_like(p)
        mu, nu = state.mu[k], state.nu[k]
        mu.mul_(opt.b1).add_(g * (1 - opt.b1))
        nu.mul_(opt.b2).add_((g * g) * (1 - opt.b2))
        update = (mu * inv_bc1) / (torch.sqrt(nu * inv_bc2) + opt.eps)
        p.add_(update * neg_lr)
    state.count += 1


def apply_group_updates(optimizers, opt_states, params_by_group, grads_by_group, scalars=None) -> None:
    """Adam on every group of `params_by_group`, in place. `scalars`: each
    group's (3,) device row of `adam_scalars` (a CUDA graph's table), by
    group name."""
    for name, params in params_by_group.items():
        adam_update(
            optimizers[name], opt_states[name], params, grads_by_group[name],
            None if scalars is None else scalars[name],
        )
