"""Readings that set a training cell's limits: the program's numbers on
many seeds, and those of the lower-precision control and of the planted
half-batch fault, each in the program's place, in one process.

    python3 fgbench/calibrate.py --workload s1_train_chunk10 --seeds 1 2 3 [--controls 3]

For each seed the cell's set-up runs and the program takes its checked
steps (no window); then the reference follows them, and for the first
`--controls` seeds also the control (the reference with every field
product operand rounded through float8 e4m3 and TF32 on for the f32
products: one step below the configuration's bf16 field and full-f32 rest)
and the fault (the image losses over half the rows). Prints one JSON line a
seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

import checks  # noqa: E402
import run as runner  # noqa: E402
import train  # noqa: E402
from reference import core  # noqa: E402


def as_program(ref: dict, other: dict) -> tuple:
    """`other` (a reference run) in the program's place: its losses, its
    first step's moments (0.1 g from zero), its parameters."""
    mu1 = {k: (1.0 - checks.ADAM_B1) * g for k, g in other["grads"].items()}
    return {**ref, "prog_losses": other["losses"]}, mu1, other["params"]


def readings(cfg, traffic, seed: int, dev, controls: bool) -> dict:
    work = train.scratch_dir()
    try:
        inputs, trainer = train.prepare(cfg, traffic, seed, dev, work)
        checked, mu1, p_end = train.first_steps(trainer, inputs, traffic)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        start = train.start_leaves(inputs)
        ref = train.follow(cfg, traffic, inputs, checked, dev)
        out = {"seed": seed, "frames": [f for _, f, _ in checked]}
        out["program"], out["program_leaves"] = checks.training_numbers(ref, mu1, p_end, start)
        if controls:
            ctrl = train.follow(cfg, traffic, inputs, checked, dev, quant=core.fp8_round, tf32=True)
            out["control"], out["control_leaves"] = checks.training_numbers(*as_program(ref, ctrl), start)
            half = train.follow(cfg, traffic, inputs, checked, dev, half=True)
            out["half_batch"], out["half_leaves"] = checks.training_numbers(*as_program(ref, half), start)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def view_readings(cell, cfg, traffic, seed: int, dev, controls: bool) -> dict:
    """The viewer's number for the program (a short window's served frames)
    and, with `controls`, for the control (the reference's field rounded
    through float8, TF32 on) and the fault (the bottom half of each frame
    left black), each in the program's place over the same sample."""
    import numpy as np

    import view

    res = view.run(cell, cfg, traffic, seed, 4.0, False, 0.0, device="cuda", keep=True)
    inputs, served = res["inputs"], res["served"]
    w, h, fx = traffic["width"], traffic["height"], traffic["fx"]
    out = {"seed": seed, "requests": len(served), "program": res["verdict"]["numbers"]}
    if controls:
        ctrl = half = 0.0
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        for i in view.sample(served, traffic["sample"], seed):
            v = served[i][1]
            want = view.reference_jpeg(inputs, v, w, h, fx, dev)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                got = view.reference_jpeg(inputs, v, w, h, fx, dev, quant=core.fp8_round)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
            ctrl = max(ctrl, float(np.abs(got - want).mean()))
            cut = want.copy()
            cut[h // 2:] = 0
            half = max(half, float(np.abs(cut - want).mean()))
        out["control"] = {"jpeg_mad": ctrl}
        out["half_frame"] = {"jpeg_mad": half}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args()
    torch.set_num_threads(1)
    bench = runner.load_json(runner.ROOT / "BENCHMARK.json")
    cell, cfg, traffic = runner.cell_parts(bench, args.workload)
    dev = torch.device("cuda")
    for i, seed in enumerate(args.seeds):
        if traffic["kind"] == "view":
            line = view_readings(cell, cfg, traffic, seed, dev, i < args.controls)
        else:
            line = readings(cfg, traffic, seed, dev, i < args.controls)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
