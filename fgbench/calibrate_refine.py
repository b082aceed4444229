"""Readings that set the limits of the refinement check (`train_refine.py`):
for each seed the cell's set-up, the program's checked steps and warm-up
to the first refinement, with a planted fault in the program's call (one
threshold doubled, `--fault`: `cull_alpha_thresh` by default, or
`densify_grad_thresh`, which changes nothing where no row's statistic is
near its threshold; the reference keeps the configuration's), and, on the same kept inputs,
the control (the reference's decisions and children computed from values
rounded to bfloat16, one step below the configuration's float32) in the
program's place. One JSON line a seed; the program's own readings come
from the cell's runs (`checks`). The benchmark's own runs never run this.

    python3 fgbench/calibrate_refine.py --workload s1_train_1296 --seeds 1 2 3 [--fault densify_grad_thresh]
"""

from __future__ import annotations

import argparse
import dataclasses
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

import run as runner  # noqa: E402
import train  # noqa: E402
import train_refine  # noqa: E402
from reference import densify  # noqa: E402


FAULTS = ("cull_alpha_thresh", "densify_grad_thresh")


def plant_fault(name: str = FAULTS[0]):
    """The program's refinement with the threshold `name` doubled."""
    from freegaussian_tpu_torch.engine import train_step

    refine = train_step.refine

    def doubled(cfg, *a, **k):
        return refine(dataclasses.replace(cfg, **{name: 2 * getattr(cfg, name)}), *a, **k)

    train_step.refine = doubled


def readings(cfg, traffic, seed: int, dev) -> dict:
    work = train.scratch_dir()
    try:
        inputs, trainer = train.prepare(cfg, traffic, seed, dev, work)
        train.first_steps(trainer, inputs, traffic)
        settings = densify.settings_of(cfg["settings"]["pipeline"]["model"])
        check = train_refine.RefineCheck(trainer, settings, len(inputs.i_train), control=torch.bfloat16)
        while check.numbers is None:
            trainer.train(traffic["chunk_steps"])
        return {"seed": seed, "fault": check.numbers, "control": check.control_numbers, "detail": check.detail}
    finally:
        # the trainer's graphs hold their memory pools until it is collected
        trainer = check = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS, default=FAULTS[0])
    args = p.parse_args()
    torch.set_num_threads(1)
    bench = runner.load_json(runner.ROOT / "BENCHMARK.json")
    _, cfg, traffic = runner.cell_parts(bench, args.workload)
    plant_fault(args.fault)
    for seed in args.seeds:
        print(json.dumps(readings(cfg, traffic, seed, torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
