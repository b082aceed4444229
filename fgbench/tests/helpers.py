"""Shared set-up of the benchmark's CPU tests: the harness on sys.path and a
tiny copy of a training cell (a few thousand Gaussians, small frames, tile
16) that the program's plain versions run on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

FGBENCH = Path(__file__).resolve().parents[1]
ROOT = FGBENCH.parent
for p in (str(FGBENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


TRAIN_CELLS = ("s1_train_chunk10", "s2_train_chunk10")


def planted_addition(root: Path) -> Path:
    """A copy of the benchmark under `root` with a full-frame cell added
    the way a later PR adds one, as files and entries alone: a
    configuration and a traffic file, the cell appended to `workloads` and
    the lists of `train_step_ms` and of every per-layer metric of the
    training cells (PR 15's eight among them), and a per-layer entry
    appended after the others, with its reader."""
    b = bench()
    shutil.copytree(FGBENCH, root / "fgbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((FGBENCH / "configs" / "fg-sim-stage1.json").read_text())
    cfg["name"] = "fg-planted-1296"
    cfg["scene"].update(gaussians=1_000_000, width=1296, height=968, focal=1012.5)
    cfg["settings"]["capacity"] = 1 << 21
    (root / "fgbench" / "configs" / "fg-planted-1296.json").write_text(json.dumps(cfg))
    traffic = json.loads((FGBENCH / "traffic" / "train_chunk10.json").read_text())
    traffic["settings"] = {"scan_chunk": 10}
    (root / "fgbench" / "traffic" / "planted_chunk10.json").write_text(json.dumps(traffic))
    (root / "fgbench" / "metrics" / "planted.gap_ms.train.py").write_text("def read(ctx):\n    return None\n")
    cell = "s1_train_1296_planted"
    b["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": "fgbench/configs/fg-planted-1296.json",
                         "reduced": cfg["reduced"], "why": "a full-frame stage 1, planted"})
    b["workloads"].append({"name": cell, "config": cfg["name"], "traffic": "planted_chunk10", "chips": 1,
                           "why": "a full-frame cell added as files and entries alone"})
    for m in b["end_to_end"] + b["per_layer"]:
        if set(TRAIN_CELLS) <= set(m.get("workloads", ())):
            m["workloads"].append(cell)
    b["per_layer"].append({"name": "planted.gap_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
                           "layer": "train step", "moves": "train_step_ms", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return root


@pytest.fixture(params=["repo", "planted"])
def tree(request, tmp_path) -> Path:
    """The root of a benchmark: the repository's, or a copy holding a
    planted addition (`planted_addition`)."""
    return ROOT if request.param == "repo" else planted_addition(tmp_path)


def tiny_cell(name: str = "s1_train_chunk10"):
    import run

    cell, cfg, traffic = run.cell_parts(bench(), name)
    cfg = copy.deepcopy(cfg)
    cfg["scene"].update(gaussians=1500, frames=6, width=64, height=48, focal=50.0)
    cfg["settings"]["capacity"] = 2048
    cfg["settings"]["vis"] = ""
    cfg["settings"]["pipeline"]["model"]["tile_size"] = 16
    # the binning's capacity from the tiny scene, by the program's own rule
    settings = dict(traffic["settings"], pipeline={"model": {"isect_capacity": None}})
    traffic = dict(traffic, warm_steps=0, trace_steps=1, chunk_steps=1, settings=settings)
    return cell, cfg, traffic


def view_parts():
    """The viewer cell, its configuration and its traffic (the cell is not
    in `BENCHMARK.json` yet: PERF.md §7)."""
    cell = {"name": "s1_view_1296", "config": "fg-sim-stage1", "traffic": "view_1296", "chips": 1}
    cfg = json.loads((FGBENCH / "configs" / "fg-sim-stage1.json").read_text())
    return cell, cfg, json.loads((FGBENCH / "traffic" / "view_1296.json").read_text())


def tiny_view():
    cell, cfg, traffic = view_parts()
    cfg = copy.deepcopy(cfg)
    cfg["scene"].update(gaussians=1500, frames=6, width=64, height=48, focal=50.0)
    cfg["settings"]["capacity"] = 2048
    cfg["settings"]["vis"] = ""
    cfg["settings"]["pipeline"]["model"]["tile_size"] = 16
    traffic = dict(traffic, width=80, height=60, path_views=12, warm_requests=1, trace_requests=3, sample=2)
    return cell, cfg, traffic
