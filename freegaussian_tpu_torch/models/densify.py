"""Adaptive density control on padded-capacity tensors (twin of
`freegaussian_tpu/models/densify.py`).

Semantics of the reference (freegaussian_model.py:369-571):
  - per-step stats: accumulate absgrad norms, visibility counts, max 2D radius
  - every `refine_every` steps from `refine_start`:
      split  (screen-large, or world-large with a high gradient): two samples
             drawn from the Gaussian itself, scales / 1.6, source culled
      dup    (small with a high gradient): a copy
      cull   (low opacity; after the first reset also world- or screen-huge)
      opacity reset every reset_alpha_every * refine_every steps
  - the reference's Adam row surgery becomes zeroing the moment rows of
    removed and (re)used slots.

New Gaussians go into the dead slots in index order (a stable argsort of
the alive mask), and what does not fit is dropped, as in the JAX package.
The split samples' normal draws come from a `torch.Generator`, or are
passed in (`split_eps`) so that a test can hand both packages the same
numbers. `refine` returns new tensors; the caller writes them back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.math import quat_to_rotmat, safe_norm
from .gaussians import GaussianParams


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """(mirrors FreeGaussianModelConfig, freegaussian_model.py:56-99)"""

    refine_start: int = 500
    refine_every: int = 100
    reset_alpha_every: int = 30
    stop_split_at: int = 15000
    stop_screen_size_at: int = 4000
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    continue_cull_post_densification: bool = True


@dataclasses.dataclass
class DensifyState:
    xys_grad_norm: torch.Tensor  # (N,)
    vis_counts: torch.Tensor  # (N,)
    max_2dsize: torch.Tensor  # (N,)

    @classmethod
    def create(cls, capacity: int, device=None) -> "DensifyState":
        return cls(
            xys_grad_norm=torch.zeros(capacity, device=device),
            vis_counts=torch.ones(capacity, device=device),
            max_2dsize=torch.zeros(capacity, device=device),
        )


def update_stats(
    state: DensifyState, radii: torch.Tensor, absgrad: torch.Tensor, last_size: Tuple[int, int]
) -> DensifyState:
    """Accumulate one step's statistics from the int 3-sigma radii
    (`info.radii`) and the absgrad (ref: freegaussian_model.py:369-392)."""
    visible = radii > 0
    grads = torch.linalg.vector_norm(absgrad, dim=-1)
    max_hw = float(max(last_size))
    return DensifyState(
        vis_counts=state.vis_counts + visible,
        xys_grad_norm=state.xys_grad_norm + torch.where(visible, grads, torch.zeros_like(grads)),
        max_2dsize=torch.where(
            visible, torch.maximum(state.max_2dsize, radii.float() / max_hw), state.max_2dsize
        ),
    )


def _scatter_new(
    params: GaussianParams,
    alive: torch.Tensor,
    new_vals: GaussianParams,
    valid: torch.Tensor,
    free_idx: torch.Tensor,
    offset: torch.Tensor,
    num_free: torch.Tensor,
):
    """Write `new_vals[i]` (where valid[i]) into the next free slots, in
    place; overflow past the free pool is dropped. Returns the number placed."""
    rank = torch.cumsum(valid.long(), 0) - 1
    pos = offset + rank
    can_place = valid & (pos < num_free)
    src = torch.nonzero(can_place)[:, 0]
    target = free_idx[pos[src]]
    for name, arr in params.items():
        arr[target] = new_vals[name][src]
    alive[target] = True
    return can_place.sum()


def refine(
    cfg: DensifyConfig,
    params: GaussianParams,
    alive: torch.Tensor,
    state: DensifyState,
    step: int,
    last_size: Tuple[int, int],
    num_train_data: int,
    *,
    generator: Optional[torch.Generator] = None,
    split_eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[GaussianParams, torch.Tensor, DensifyState, Dict[str, torch.Tensor]]:
    """One refinement pass. Returns (new params, new alive, reset stats,
    info) with info = {moment_zero_mask (N,) bool, reset_opacity_moments
    bool, num_culled, num_split, num_dup, num_alive}. `split_eps`: the two
    (N, 3) standard-normal draws of the split samples; drawn from
    `generator` when not given."""
    capacity = alive.shape[0]
    dev = alive.device
    max_hw = float(max(last_size))
    reset_interval = cfg.reset_alpha_every * cfg.refine_every
    params = {k: v.detach() for k, v in params.items()}

    do_densify = step < cfg.stop_split_at and (step % reset_interval) > (num_train_data + cfg.refine_every)
    scale_max = torch.exp(params["scales"]).amax(dim=-1)

    avg_grad = state.xys_grad_norm / state.vis_counts * 0.5 * max_hw
    high_grads = avg_grad > cfg.densify_grad_thresh
    splits = (scale_max > cfg.densify_size_thresh) & high_grads
    if step < cfg.stop_screen_size_at:
        splits = splits | (state.max_2dsize > cfg.split_screen_size)
    splits = splits & alive & do_densify
    dups = (scale_max <= cfg.densify_size_thresh) & high_grads & alive & do_densify

    # split samples: x = mean + R(quat) (exp(scale) * eps), scales / 1.6
    quats_n = params["quats"] / safe_norm(params["quats"], dim=-1, keepdim=True)
    rots = quat_to_rotmat(quats_n)
    scale_lin = torch.exp(params["scales"])
    size_fac = 1.6
    if split_eps is None:
        gdev = generator.device if generator is not None else dev
        split_eps = tuple(
            torch.randn(params["means"].shape, generator=generator, device=gdev).to(dev) for _ in range(2)
        )

    def split_sample(eps):
        offs = torch.einsum("nij,nj->ni", rots, scale_lin * eps)
        return {
            "means": params["means"] + offs,
            "scales": torch.log(torch.clamp(scale_lin / size_fac, min=1e-12)),
            "quats": params["quats"],
            "features_dc": params["features_dc"],
            "features_rest": params["features_rest"],
            "opacities": params["opacities"],
        }

    # culling (ref: freegaussian_model.py:493-522)
    low_opacity = torch.sigmoid(params["opacities"][..., 0]) < cfg.cull_alpha_thresh
    post_warmup = step > cfg.refine_every * cfg.reset_alpha_every
    toobig_world = scale_max > cfg.cull_scale_thresh
    toobig_screen = (state.max_2dsize > cfg.cull_screen_size) & (step < cfg.stop_screen_size_at)
    culls = low_opacity | (post_warmup & (toobig_world | toobig_screen))
    culls = culls | splits  # split sources go once their samples are placed
    do_cull = do_densify or (step >= cfg.stop_split_at and cfg.continue_cull_post_densification)
    culls = culls & alive & do_cull

    new_alive = alive & ~culls
    # The reference culls after appending, so new Gaussians that already meet
    # the cull criteria are not placed.
    split_world_big = post_warmup & (scale_max / size_fac > cfg.cull_scale_thresh)
    dup_world_big = post_warmup & toobig_world
    splits_valid = splits & ~(low_opacity | split_world_big)
    dups_valid = dups & ~(low_opacity | dup_world_big)

    free_idx = torch.argsort(new_alive.int(), stable=True)
    num_free = (~new_alive).sum()
    out = {k: v.clone() for k, v in params.items()}
    n_alloc = torch.zeros((), dtype=torch.long, device=dev)
    for sample_vals, valid in (
        (split_sample(split_eps[0]), splits_valid),
        (split_sample(split_eps[1]), splits_valid),
        (params, dups_valid),
    ):
        n_alloc = n_alloc + _scatter_new(out, new_alive, sample_vals, valid, free_idx, n_alloc, num_free)

    # new slots need zeroed moments: the first n_alloc entries of free_idx
    slot_rank = torch.argsort(free_idx)
    moment_zero = culls | (slot_rank < n_alloc)

    # opacity reset (ref: freegaussian_model.py:475-487)
    do_reset = step < cfg.stop_split_at and (step % reset_interval) == cfg.refine_every
    if do_reset:
        reset_logit = torch.log(torch.tensor(2 * cfg.cull_alpha_thresh / (1 - 2 * cfg.cull_alpha_thresh)))
        out["opacities"] = torch.minimum(out["opacities"], reset_logit.to(dev))

    info = {
        "moment_zero_mask": moment_zero,
        "reset_opacity_moments": do_reset,
        "num_culled": culls.sum(),
        "num_split": splits.sum(),
        "num_dup": dups.sum(),
        "num_alive": new_alive.sum(),
    }
    return out, new_alive, DensifyState.create(capacity, device=dev), info


def zero_moment_rows(state, mask: torch.Tensor, param_template: torch.Tensor):
    """Zero the Adam moment rows selected by `mask`, in place, in every
    moment tensor of `state` (an `AdamState`) shaped like the parameter.
    The step count is left as it is."""
    for moments in (state.mu, state.nu):
        for k, m in moments.items():
            if m.shape == param_template.shape:
                moments[k] = torch.where(mask.reshape(mask.shape + (1,) * (m.ndim - 1)), torch.zeros_like(m), m)
    return state
