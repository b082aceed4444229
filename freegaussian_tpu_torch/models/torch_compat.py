"""Reference-format checkpoints and the weight bridge from the JAX package.

A reference checkpoint is a nerfstudio `step-%09d.ckpt`:
`{"pipeline": state_dict, "step": int}` with keys `_model.gauss_params.*`
and `_model.deform.*` (possibly under DDP `module.` prefixes). The port's
`SplatModel` uses the same key names, so loading is a prefix strip, a
reshape of features_rest to its flat layout and a `load_state_dict`.

`state_from_jax_arrays` builds a `SplatModel` from the JAX package's numpy
arrays (padded params, alive mask and flax DeformField variables, whose
`TorchLinear_i` kernels are (in, out)); the tests use it to hand both
packages identical weights. `adam_state_from_optax` and
`train_state_from_jax` carry a whole training state across: the optax Adam
states (count, mu, nu; read by attribute name, without importing optax)
and the densification statistics, so both packages can start a training
step from the same state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .gaussians import PARAM_NAMES
from .splat_model import SplatConfig, SplatModel, make_deform_field

def _deform_layer_names(is_blender: bool, depth: int = 8):
    """Creation order of the flax DeformField's TorchLinear_i layers."""
    return (
        (["timenet.0", "timenet.2"] if is_blender else [])
        + [f"linear.{d}" for d in range(depth)]
        + ["branch_w", "branch_v", "gaussian_rotation", "gaussian_scaling"]
    )


def _strip_prefixes(pipeline_state: Dict[str, Any]) -> Dict[str, Any]:
    """Drop DDP `module.` and the pipeline's `_model.` prefixes."""
    state = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in pipeline_state.items()}
    model_state = {}
    is_ddp = True
    for k, v in state.items():
        if k.startswith("_model."):
            model_state[k[len("_model."):]] = v
            if not k.startswith("_model.module."):
                is_ddp = False
    if is_ddp and model_state:
        model_state = {k[len("module."):]: v for k, v in model_state.items()}
    return model_state


def _model_from_arrays(
    gauss: Dict[str, torch.Tensor], deform_state: Dict[str, torch.Tensor], *,
    capacity: Optional[int], cfg: SplatConfig, step: int, device,
) -> SplatModel:
    n = gauss["means"].shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint gaussians {n}")
    sh_degree = int(round((gauss["features_rest"].shape[1] // 3 + 1) ** 0.5)) - 1
    if sh_degree != cfg.sh_degree:
        import dataclasses

        cfg = dataclasses.replace(cfg, sh_degree=sh_degree)
    model = SplatModel(cfg, cap, step=step, device=device)
    state = {}
    for name in PARAM_NAMES:
        arr = gauss[name].float()
        state[f"gauss_params.{name}"] = torch.cat([arr, arr.new_zeros((cap - n, *arr.shape[1:]))])
    state["alive"] = torch.arange(cap) < n
    for k, v in deform_state.items():
        state[f"deform.{k}"] = v.float()
    model.load_state_dict(state, strict=True)
    return model


def load_reference_checkpoint(
    path: Path,
    *,
    capacity: Optional[int] = None,
    cfg: Optional[SplatConfig] = None,
    device="cuda",
) -> SplatModel:
    """Load a reference torch checkpoint into a `SplatModel` on `device`."""
    from ..device import resolve_device

    device = resolve_device(device)
    cfg = cfg or SplatConfig()
    loaded = torch.load(Path(path), map_location="cpu", weights_only=True)
    model_state = _strip_prefixes(loaded["pipeline"])
    gauss = {}
    for name in PARAM_NAMES:
        key = f"gauss_params.{name}" if f"gauss_params.{name}" in model_state else name
        gauss[name] = model_state[key]
    fr = gauss["features_rest"]  # (N, K-1, 3) in the reference layout
    gauss["features_rest"] = fr.reshape(fr.shape[0], fr.shape[1] * fr.shape[2])
    names = _deform_layer_names(cfg.is_blender)
    deform_state = {}
    for layer in names:
        for p in ("weight", "bias"):
            deform_state[f"{layer}.{p}"] = model_state[f"deform.{layer}.{p}"]
    return _model_from_arrays(
        gauss, deform_state, capacity=capacity, cfg=cfg, step=int(loaded.get("step", 0)), device=device
    )


def export_reference_checkpoint(
    path: Path,
    params: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    *,
    deform: Optional[torch.nn.Module] = None,
    step: int = 0,
) -> Path:
    """Write a reference-format checkpoint holding only the live Gaussians."""
    keep = alive.detach().cpu()
    state: Dict[str, torch.Tensor] = {}
    for name in PARAM_NAMES:
        arr = params[name].detach().cpu()[keep]
        if name == "features_rest":  # flat (N, (K-1)*3) -> reference (N, K-1, 3)
            arr = arr.reshape(arr.shape[0], arr.shape[1] // 3, 3)
        state[f"_model.gauss_params.{name}"] = arr.clone()
    if deform is not None:
        for k, v in deform.state_dict().items():
            state[f"_model.deform.{k}"] = v.detach().cpu().clone()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"pipeline": state, "step": int(step)}, path)
    return path


def state_from_jax_arrays(
    params_np: Dict[str, np.ndarray],
    alive_np: np.ndarray,
    deform_vars_np: Dict[str, Any],
    *,
    cfg: Optional[SplatConfig] = None,
    step: int = 0,
    device="cuda",
) -> SplatModel:
    """The JAX package's (params, alive, flax DeformField variables) as numpy
    arrays -> a `SplatModel` holding the same weights on `device`. Flax
    kernels (in, out) become torch weights (out, in); the padded capacity
    and the alive mask are kept row for row."""
    cfg = cfg or SplatConfig()
    alive = torch.as_tensor(np.asarray(alive_np), dtype=torch.bool)
    gauss = {n: torch.as_tensor(np.asarray(params_np[n]), dtype=torch.float32) for n in PARAM_NAMES}
    deform_state = deform_state_from_flax(deform_vars_np, cfg.is_blender)
    model = _model_from_arrays(gauss, deform_state, capacity=None, cfg=cfg, step=step, device=device)
    with torch.no_grad():
        model.alive.copy_(alive)
    return model


def deform_state_from_flax(tree_np: Dict[str, Any], is_blender: bool = True) -> Dict[str, torch.Tensor]:
    """A flax DeformField tree ({"params": {"TorchLinear_i": {"kernel" (in, out),
    "bias"}}}, the variables or an Adam moment of them) -> the port's
    state_dict names with (out, in) weights."""
    layers = tree_np["params"]
    depth = len(layers) - 4 - (2 if is_blender else 0)
    out = {}
    for i, layer in enumerate(_deform_layer_names(is_blender, depth)):
        p = layers[f"TorchLinear_{i}"]
        out[f"{layer}.weight"] = torch.as_tensor(np.asarray(p["kernel"], np.float32).T.copy())
        out[f"{layer}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32).copy())
    return out


def adam_state_from_optax(group: str, opt_state_np, *, is_blender: bool = True, device="cuda"):
    """One group's optax Adam state (as numpy) -> the port's `AdamState`.
    The state is optax's chain tuple; its ScaleByAdamState is found by its
    `mu`/`nu`/`count` attributes."""
    from ..device import resolve_device
    from ..engine.optimizers import AdamState

    dev = resolve_device(device)
    adam = next(s for s in opt_state_np if {"count", "mu", "nu"} <= set(getattr(s, "_fields", ())))
    if group == "deform":
        mu = deform_state_from_flax(adam.mu, is_blender)
        nu = deform_state_from_flax(adam.nu, is_blender)
    else:
        mu = {group: torch.tensor(np.asarray(adam.mu, np.float32))}
        nu = {group: torch.tensor(np.asarray(adam.nu, np.float32))}
    return AdamState(
        count=int(np.asarray(adam.count)),
        mu={k: v.to(dev) for k, v in mu.items()},
        nu={k: v.to(dev) for k, v in nu.items()},
    )


def train_state_from_jax(
    params_np: Dict[str, np.ndarray],
    alive_np: np.ndarray,
    deform_vars_np: Optional[Dict[str, Any]],
    opt_states_np: Dict[str, Any],
    densify_np: Dict[str, np.ndarray],
    *,
    step: int,
    generator: torch.Generator,
    cfg: Optional[SplatConfig] = None,
    device="cuda",
):
    """The JAX package's TrainState fields (as numpy) -> the port's
    `TrainState` on `device`: params (as trainable leaves), alive mask,
    deform field, every group's Adam state and the densification
    statistics (`densify_np`: xys_grad_norm, vis_counts, max_2dsize)."""
    from ..device import resolve_device
    from ..engine.train_step import TrainState
    from .densify import DensifyState

    dev = resolve_device(device)
    cfg = cfg or SplatConfig()
    deform = None
    if deform_vars_np is not None:
        state = deform_state_from_flax(deform_vars_np, cfg.is_blender)
        depth = sum(1 for k in state if k.startswith("linear.") and k.endswith(".weight"))
        deform = make_deform_field(cfg, depth=depth, width=state["linear.0.weight"].shape[0])
        deform.load_state_dict(state, strict=True)
        deform = deform.to(dev)
    # copies: the step updates these in place, and a numpy buffer may be
    # shared with arrays the caller still reads
    params = {n: torch.tensor(np.asarray(params_np[n], np.float32), device=dev, requires_grad=True) for n in PARAM_NAMES}
    opt_states = {
        g: adam_state_from_optax(g, st, is_blender=cfg.is_blender, device=dev)
        for g, st in opt_states_np.items()
        if g != "deform" or deform is not None
    }
    densify = DensifyState(
        **{k: torch.tensor(np.asarray(densify_np[k], np.float32), device=dev) for k in DensifyState.__dataclass_fields__}
    )
    return TrainState(
        params=params,
        alive=torch.tensor(np.asarray(alive_np), dtype=torch.bool, device=dev),
        deform=deform,
        opt_states=opt_states,
        densify=densify,
        step=int(step),
        generator=generator,
    )
