"""Key-frame registry (twin of `freegaussian_tpu/preprocess/key_frames.py`):
the hand-picked clustering frames per scene, indices into the train split
(reference: preprocess/key_frames.yaml; this repo's configs/key_frames.yaml)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import yaml


def load_key_frames(path: Path, scene: str) -> List[int]:
    """The key-frame index list of one scene: a list, or a dict with
    `frames` (else `key_frames`)."""
    tree = yaml.safe_load(Path(path).read_text()) or {}
    if scene not in tree:
        raise KeyError(f"scene {scene!r} not in {path} (has {sorted(tree)[:8]}...)")
    entry = tree[scene]
    if isinstance(entry, dict):
        entry = entry.get("frames", entry.get("key_frames", []))
    return [int(x) for x in entry]


def save_key_frames(path: Path, registry: Dict[str, List[int]]) -> None:
    Path(path).write_text(yaml.safe_dump({k: list(map(int, v)) for k, v in registry.items()}))
