"""Reference-format checkpoints and the weight bridge from the JAX package.

A reference checkpoint is a nerfstudio `step-%09d.ckpt`:
`{"pipeline": state_dict, "step": int}` with keys `_model.gauss_params.*`
and `_model.deform.*`, and for a stage-2 model `_model.control.*` (possibly
under DDP `module.` prefixes). The port's `SplatModel` and `ControlModel`
use the same key names, so loading is a prefix strip, a reshape of
features_rest to its flat layout and a `load_state_dict`. A stage-2 model
also needs its cluster mask (`gaussian_mask_NxM.npy`): `load_control_checkpoint`
serves a stage-2 checkpoint (`engine/checkpoints.py:cross_load_stage1`
starts stage-2 training from a stage-1 one).

`state_from_jax_arrays` builds a `SplatModel` from the JAX package's numpy
arrays (padded params, alive mask and flax DeformField variables, whose
`TorchLinear_i` kernels are (in, out)); the tests use it to hand both
packages identical weights, and `control_state_from_flax` does the same for
a flax ControlField. `adam_state_from_optax` and `train_state_from_jax`
carry a whole training state across: the optax Adam states (count, mu, nu;
read by attribute name, without importing optax), the densification
statistics and, for stage 2, the control field, so both packages can start
a training step from the same state.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .fields import CONTROL_HEAD_NAMES
from .gaussians import PARAM_NAMES
from .splat_model import SplatConfig, SplatModel, make_control_field, make_deform_field

def _deform_layer_names(is_blender: bool, depth: int = 8):
    """Creation order of the flax DeformField's TorchLinear_i layers."""
    return (
        (["timenet.0", "timenet.2"] if is_blender else [])
        + [f"linear.{d}" for d in range(depth)]
        + ["branch_w", "branch_v", "gaussian_rotation", "gaussian_scaling"]
    )


def _control_layer_names(depth: int = 8):
    """Creation order of the flax ControlField's TorchLinear_i layers."""
    return [f"linear.{d}" for d in range(depth)] + list(CONTROL_HEAD_NAMES)


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
    return _load_model(SplatModel(_fit_cfg(gauss, cfg), _capacity(gauss, capacity), step=step, device=device),
                       gauss, deform_state)


def _capacity(gauss: Dict[str, torch.Tensor], capacity: Optional[int]) -> int:
    n = gauss["means"].shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < checkpoint gaussians {n}")
    return cap


def _fit_cfg(gauss: Dict[str, torch.Tensor], cfg: SplatConfig) -> SplatConfig:
    """`cfg` with the checkpoint's SH degree."""
    sh_degree = int(round((gauss["features_rest"].shape[1] // 3 + 1) ** 0.5)) - 1
    if sh_degree != cfg.sh_degree:
        import dataclasses

        cfg = dataclasses.replace(cfg, sh_degree=sh_degree)
    return cfg


def _load_model(model: SplatModel, gauss, deform_state, extra: Optional[Dict[str, torch.Tensor]] = None):
    """Fill `model` with the live Gaussians (padded to its capacity, alive
    first), the deform field and `extra` state_dict entries, strictly."""
    n = gauss["means"].shape[0]
    cap = model.alive.shape[0]
    state = {}
    for name in PARAM_NAMES:
        arr = gauss[name].float()
        state[f"gauss_params.{name}"] = torch.cat([arr, arr.new_zeros((cap - n, *arr.shape[1:]))])
    state["alive"] = torch.arange(cap) < n
    for k, v in deform_state.items():
        state[f"deform.{k}"] = v.float()
    state.update(extra or {})
    model.load_state_dict(state, strict=True)
    return model


def _read_reference(path: Path, cfg: SplatConfig):
    """A reference checkpoint's (live Gaussians, deform state_dict, the
    model's whole state_dict, step)."""
    loaded = torch.load(Path(path), map_location="cpu", weights_only=True)
    model_state = _strip_prefixes(loaded["pipeline"])
    gauss = {}
    for name in PARAM_NAMES:
        key = f"gauss_params.{name}" if f"gauss_params.{name}" in model_state else name
        gauss[name] = model_state[key]
    fr = gauss["features_rest"]  # (N, K-1, 3) in the reference layout
    gauss["features_rest"] = fr.reshape(fr.shape[0], fr.shape[1] * fr.shape[2])
    deform_state = {}
    for layer in _deform_layer_names(cfg.is_blender):
        for p in ("weight", "bias"):
            deform_state[f"{layer}.{p}"] = model_state[f"deform.{layer}.{p}"]
    return gauss, deform_state, model_state, int(loaded.get("step", 0))


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
    gauss, deform_state, _, step = _read_reference(path, cfg)
    return _model_from_arrays(gauss, deform_state, capacity=capacity, cfg=cfg, step=step, device=device)


def _control_model(path, gaussian_mask_path, capacity, cfg, device, control_state):
    """A `ControlModel` from a reference checkpoint and a mask file, with the
    control field's state from `control_state(model_state, model)`."""
    from ..device import resolve_device
    from ..preprocess.clustering import load_gaussian_mask
    from .control_model import ControlModel

    device = resolve_device(device)
    cfg = cfg or SplatConfig()
    gauss, deform_state, model_state, step = _read_reference(path, cfg)
    cap = _capacity(gauss, capacity)
    alive = torch.arange(cap) < gauss["means"].shape[0]
    mask = load_gaussian_mask(Path(gaussian_mask_path), cap, alive)
    model = ControlModel(_fit_cfg(gauss, cfg), cap, mask.shape[1], step=step, device=device)
    extra = {f"control.{k}": v.float() for k, v in control_state(model_state, model).items()}
    extra["gaussian_mask"] = mask
    return _load_model(model, gauss, deform_state, extra)


def load_control_checkpoint(
    path: Path,
    gaussian_mask_path: Path,
    *,
    capacity: Optional[int] = None,
    cfg: Optional[SplatConfig] = None,
    device="cuda",
):
    """Load a stage-2 reference checkpoint (with `control.*` keys, as the
    JAX package's `export --format torch` writes it) and its cluster mask
    into a `ControlModel` on `device`."""

    def control_state(model_state, model):
        if not any(k.startswith("control.") for k in model_state):
            raise KeyError(f"{path} has no control.* keys: a stage-1 checkpoint starts stage 2 with engine.checkpoints.cross_load_stage1")
        return {k: model_state[f"control.{k}"] for k in model.control.state_dict()}

    return _control_model(path, gaussian_mask_path, capacity, cfg, device, control_state)


def export_reference_checkpoint(
    path: Path,
    params: Dict[str, torch.Tensor],
    alive: torch.Tensor,
    *,
    deform: Optional[torch.nn.Module] = None,
    control: Optional[torch.nn.Module] = None,
    step: int = 0,
) -> Path:
    """Write a reference-format checkpoint holding only the live Gaussians,
    and the deform and control fields when given."""
    keep = alive.detach().cpu()
    state: Dict[str, torch.Tensor] = {}
    for name in PARAM_NAMES:
        arr = params[name].detach().cpu()[keep]
        if name == "features_rest":  # flat (N, (K-1)*3) -> reference (N, K-1, 3)
            arr = arr.reshape(arr.shape[0], arr.shape[1] // 3, 3)
        state[f"_model.gauss_params.{name}"] = arr.clone()
    for prefix, field in (("deform", deform), ("control", control)):
        if field is not None:
            for k, v in field.state_dict().items():
                state[f"_model.{prefix}.{k}"] = v.detach().cpu().clone()
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


def _state_from_flax(tree_np: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    out = {}
    for i, layer in enumerate(names):
        p = tree_np["params"][f"TorchLinear_{i}"]
        out[f"{layer}.weight"] = torch.as_tensor(np.asarray(p["kernel"], np.float32).T.copy())
        out[f"{layer}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32).copy())
    return out


def deform_state_from_flax(tree_np: Dict[str, Any], is_blender: bool = True) -> Dict[str, torch.Tensor]:
    """A flax DeformField tree ({"params": {"TorchLinear_i": {"kernel" (in, out),
    "bias"}}}, the variables or an Adam moment of them) -> the port's
    state_dict names with (out, in) weights."""
    depth = len(tree_np["params"]) - 4 - (2 if is_blender else 0)
    return _state_from_flax(tree_np, _deform_layer_names(is_blender, depth))


def control_state_from_flax(tree_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ControlField tree (the variables or an Adam moment of them) ->
    the port's `ControlField` state_dict names with (out, in) weights."""
    return _state_from_flax(tree_np, _control_layer_names(len(tree_np["params"]) - 3))


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
    elif group == "control":
        mu = control_state_from_flax(adam.mu)
        nu = control_state_from_flax(adam.nu)
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
    control_vars_np: Optional[Dict[str, Any]] = None,
    device="cuda",
):
    """The JAX package's TrainState fields (as numpy) -> the port's
    `TrainState` on `device`: params (as trainable leaves), alive mask,
    deform field, the control field (`control_vars_np`, stage 2), every
    group's Adam state and the densification statistics (`densify_np`:
    xys_grad_norm, vis_counts, max_2dsize)."""
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
    control = None
    if control_vars_np is not None:
        state = control_state_from_flax(control_vars_np)
        depth = sum(1 for k in state if k.startswith("linear.") and k.endswith(".weight"))
        control = make_control_field(cfg, depth=depth, width=state["linear.0.weight"].shape[0])
        control.load_state_dict(state, strict=True)
        control = control.to(dev)
    # copies: the step updates these in place, and a numpy buffer may be
    # shared with arrays the caller still reads
    params = {n: torch.tensor(np.asarray(params_np[n], np.float32), device=dev, requires_grad=True) for n in PARAM_NAMES}
    opt_states = {
        g: adam_state_from_optax(g, st, is_blender=cfg.is_blender, device=dev)
        for g, st in opt_states_np.items()
        if (g != "deform" or deform is not None) and (g != "control" or control is not None)
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
        control=control,
    )
