"""Run one cell of the benchmark once and print its result line.

    python3 fgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`fgbench/configs/<config>.json`) and a traffic mix
(`fgbench/traffic/<traffic>.json`); the traffic's `kind` picks the module
that runs it (`fgbench/<kind>.py`). With `--trace 0` the line carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, each read by
`fgbench/metrics/<metric>.py`. The last lines of standard error, and the
last key of the result line, give each number that decided `correct`
beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "freegaussian_tpu")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: `freegaussian_tpu_torch` is the port)."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"fgbench: no {what} named {name!r} in BENCHMARK.json")


def module_at(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_parts(bench: dict, name: str):
    cell = find(bench["workloads"], name, "workload")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """The cell's run by its kind's module, then its metrics: a dict of the result line's
    keys (without `device.kind`)."""
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))
    cell, cfg, traffic = cell_parts(bench, name)
    kind = module_at(HERE / f"{traffic['kind']}.py")
    res = kind.run(cell, cfg, traffic, seed, seconds, trace, T_PROCESS, device=device)
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if applies(m, name) and res.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(res[m["name"]]), "unit": m["unit"]}
    else:
        ctx = {"cell": cell, "config": cfg, "traffic": traffic, **res}
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            value = module_at(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    verdict = res["verdict"]
    out = {
        "correct": bool(verdict["correct"]) and res["failed"] == 0,
        "attempted": int(res["attempted"]),
        "failed": int(res["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device, "count": int(cell["chips"]),
                   "memory_peak_bytes": int(res["memory_peak_bytes"])},
    }
    if trace:
        out["device"].update(busy_s=res["trace"]["busy_s"], window_s=res["trace"]["window_s"])
        out["breakdown"] = res["trace"]["breakdown"]
    out["checks"] = {k: {"value": v, "limit": verdict["limits"][k]} for k, v in verdict["numbers"].items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # one host thread for the CPU side of torch (the load comes from one process)
    os.environ["OMP_NUM_THREADS"] = "1"
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find(bench["workloads"], args.workload, "workload")

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"fgbench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    found = forbidden_modules()
    if found:
        print(f"fgbench: JAX or the JAX package was loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
