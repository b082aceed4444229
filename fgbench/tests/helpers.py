"""Shared set-up of the benchmark's CPU tests: the harness on sys.path and a
tiny copy of a training cell (a few thousand Gaussians, small frames, tile
16) that the program's plain versions run on the CPU."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

FGBENCH = Path(__file__).resolve().parents[1]
ROOT = FGBENCH.parent
for p in (str(FGBENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


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
