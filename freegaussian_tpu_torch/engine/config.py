"""Config system (twin of `freegaussian_tpu/engine/config.py`): a YAML overlay
(family base.yaml + scene.yaml) with the `${eval:...}` arithmetic resolver,
applied onto the port's `TrainerConfig`, `SplatConfig`, `DensifyConfig` and
`OptimizersConfig`.

It reads YAML with PyYAML's `safe_load`, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from .trainer import TrainerConfig

_EVAL_RE = re.compile(r"^\$\{eval:(.*)\}$")


def load_yaml(path: Path) -> Dict[str, Any]:
    """One YAML file as nested dicts; an empty document is {}."""
    return yaml.safe_load(Path(path).read_text()) or {}


def _resolve(value: Any) -> Any:
    """Resolve `${eval:expr}` strings (arithmetic only, mirroring the
    reference's OmegaConf eval resolver)."""
    if isinstance(value, str):
        m = _EVAL_RE.match(value.strip())
        if m:
            expr = m.group(1)
            if not re.fullmatch(r"[-+*/(). \d eE]*", expr):
                raise ValueError(f"unsafe eval expression: {expr}")
            return eval(expr, {"__builtins__": {}}, {})
    return value


def deep_merge(base: Dict, overlay: Dict) -> Dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def resolve_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: resolve_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolve_tree(v) for v in tree]
    return _resolve(tree)


def load_yaml_overlay(base_path: Path, scene_path: Optional[Path] = None) -> Dict:
    """base.yaml + scene.yaml merge with eval resolution
    (ref: scripts/parse_config.py:parse_yaml)."""
    base = load_yaml(base_path)
    if scene_path and Path(scene_path).is_file():
        base = deep_merge(base, load_yaml(scene_path))
    return resolve_tree(base)


def _apply_fields(dc, values: Dict):
    """Apply a flat/nested dict onto a (frozen or mutable) dataclass."""
    updates = {}
    for f in dataclasses.fields(dc):
        if f.name not in values:
            continue
        v = values[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[f.name] = _apply_fields(cur, v)
        else:
            updates[f.name] = v
    return dataclasses.replace(dc, **updates)


def trainer_config_from_yaml(base_path: Path, scene_path: Optional[Path] = None, **overrides) -> TrainerConfig:
    """Build a TrainerConfig from the YAML overlay (as the JAX package does):
    top-level trainer fields, spatial_lr_scale and max_num_iterations folded
    into the optimizer config, pipeline.model.* (and model.*) onto
    SplatConfig / DensifyConfig, dataparser -> its name and kwargs."""
    tree = load_yaml_overlay(base_path, scene_path)
    tree = deep_merge(tree, overrides)

    cfg = _apply_fields(TrainerConfig(), tree)
    opt = _apply_fields(cfg.optimizers, tree.get("optimizers", {}))
    opt = dataclasses.replace(
        opt,
        spatial_lr_scale=float(tree.get("spatial_lr_scale", 1.0)),
        max_steps=int(tree.get("max_num_iterations", cfg.max_num_iterations)),
    )
    model_tree = deep_merge(tree.get("pipeline", {}).get("model", {}), tree.get("model", {}))
    dp = tree.get("dataparser", {})
    return dataclasses.replace(
        cfg,
        splat=_apply_fields(cfg.splat, model_tree),
        densify=_apply_fields(cfg.densify, model_tree),
        optimizers=opt,
        dataparser=dp.get("name", cfg.dataparser),
        dataparser_kwargs={k: v for k, v in dp.items() if k != "name"},
    )
