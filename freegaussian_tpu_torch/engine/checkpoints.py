"""Training-state checkpoints (twin of `freegaussian_tpu/engine/checkpoints.py`).

The JAX package writes orbax step directories; the port writes
`<directory>/<step>/state.pt` with `torch.save` and reads it back with
`torch.load(weights_only=True)`: the Gaussian parameters and alive mask,
the deform and control fields, every Adam group (count, mu, nu), the
densification statistics, the step and the random generator's state.
Re-saving a step overwrites it, as the JAX package's does. Orbax
checkpoints are not read; `models/torch_compat.py` bridges JAX states and
reference-format `.ckpt` files.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..models.densify import DensifyState
from .optimizers import AdamState

_FILE = "state.pt"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_dict(state) -> Dict[str, Any]:
    """A TrainState as nested dicts of CPU tensors and ints."""
    return {
        "params": {k: _cpu(v) for k, v in state.params.items()},
        "alive": _cpu(state.alive),
        "deform": {k: _cpu(v) for k, v in state.deform.state_dict().items()} if state.deform is not None else None,
        "control": {k: _cpu(v) for k, v in state.control.state_dict().items()} if state.control is not None else None,
        "opt_states": {
            g: {"count": int(s.count), "mu": {k: _cpu(v) for k, v in s.mu.items()}, "nu": {k: _cpu(v) for k, v in s.nu.items()}}
            for g, s in state.opt_states.items()
        },
        "densify": {k: _cpu(getattr(state.densify, k)) for k in DensifyState.__dataclass_fields__},
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }


def save_checkpoint(directory: Path, step: int, state) -> Path:
    """Write `state` as step `step` under `directory`; returns the file."""
    stale = Path(directory).absolute() / str(int(step))
    if stale.exists():
        shutil.rmtree(stale)
    stale.mkdir(parents=True)
    path = stale / _FILE
    torch.save(state_dict(state), path)
    return path


def latest_step(directory: Path) -> int:
    steps = [int(p.name) for p in Path(directory).iterdir() if p.name.isdigit() and (p / _FILE).exists()]
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return max(steps)


def read_checkpoint(directory: Path, step: Optional[int] = None) -> Dict[str, Any]:
    """The saved nested dict of step `step` (default: the latest)."""
    directory = Path(directory).absolute()
    step = latest_step(directory) if step is None else int(step)
    return torch.load(directory / str(step) / _FILE, map_location="cpu", weights_only=True)


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str):
    if set(dst) != set(src):
        raise KeyError(f"{what}: checkpoint holds {sorted(src)}, the state {sorted(dst)}")
    for k, v in src.items():
        if dst[k].shape != v.shape:
            raise ValueError(f"{what}.{k}: checkpoint shape {tuple(v.shape)}, state {tuple(dst[k].shape)}")


def load_checkpoint(directory: Path, state, step: Optional[int] = None):
    """Restore `state` (a TrainState of the same shapes: capacity, fields,
    groups) from step `step` (default: the latest) in place, and return it."""
    saved = read_checkpoint(directory, step)
    dev = state.alive.device
    _copy_into(state.params, saved["params"], "params")
    state.params = {k: v.to(dev).requires_grad_(True) for k, v in saved["params"].items()}
    state.alive = saved["alive"].to(dev)
    for name in ("deform", "control"):
        field = getattr(state, name)
        if (field is None) != (saved[name] is None):
            raise KeyError(f"checkpoint and state disagree on the {name} field")
        if field is not None:
            field.load_state_dict(saved[name], strict=True)
    if set(saved["opt_states"]) != set(state.opt_states):
        raise KeyError(f"checkpoint optimizer groups {sorted(saved['opt_states'])}, state {sorted(state.opt_states)}")
    for g, s in saved["opt_states"].items():
        _copy_into(state.opt_states[g].mu, s["mu"], f"opt_states.{g}")
        state.opt_states[g] = AdamState(
            count=int(s["count"]),
            mu={k: v.to(dev) for k, v in s["mu"].items()},
            nu={k: v.to(dev) for k, v in s["nu"].items()},
        )
    state.densify = DensifyState(**{k: v.to(dev) for k, v in saved["densify"].items()})
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
    return state


def cross_load_stage1(path: Path, state, *, step: Optional[int] = None):
    """Start stage 2 from a stage-1 checkpoint: the Gaussians, the alive
    mask and the deform field come from it; the control field and the
    optimizer states keep their fresh initialization (the JAX package's
    strict=False restore). `path` is a port checkpoint directory, or a
    reference-format `.ckpt` file, whose live Gaussians fill the first
    slots of the state's capacity. In place; returns `state`."""
    path = Path(path)
    dev = state.alive.device
    if path.is_file():
        from ..models.splat_model import SplatConfig
        from ..models.torch_compat import _read_reference

        gauss, deform_state, _, _ = _read_reference(path, SplatConfig(is_blender=state.deform.is_blender))
        cap = state.alive.shape[0]
        n = gauss["means"].shape[0]
        if n > cap:
            raise ValueError(f"capacity {cap} < checkpoint gaussians {n}")
        params = {k: torch.cat([v.float(), v.new_zeros((cap - n, *v.shape[1:]), dtype=torch.float32)]) for k, v in gauss.items()}
        alive = torch.arange(cap) < n
    else:
        saved = read_checkpoint(path, step)
        params, alive, deform_state = saved["params"], saved["alive"], saved["deform"]
    _copy_into(state.params, params, "params")
    state.params = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
    state.alive = alive.to(dev)
    state.deform.load_state_dict({k: v.float() for k, v in deform_state.items()}, strict=True)
    return state
