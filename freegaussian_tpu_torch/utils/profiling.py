"""Profiling utilities (twin of `freegaussian_tpu/utils/profiling.py`): the
nerfstudio `profiler.time_function` equivalent (which the reference wraps
every pipeline entry with, freegaussian_pipeline.py:52-174) plus a
`torch.profiler` trace capture.

Wall time per function is accumulated into a module-level table and printed
with `profiler_summary()`. CUDA work is asynchronous: end the timed region
with `torch.cuda.synchronize()` where the device's time should count."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

_TOTALS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)


def time_function(fn):
    """Decorator accumulating wall time per call."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _TOTALS[fn.__qualname__] += time.perf_counter() - t0
            _COUNTS[fn.__qualname__] += 1

    return wrapped


@contextlib.contextmanager
def profile_section(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TOTALS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def profiler_summary(reset: bool = False) -> str:
    rows = sorted(_TOTALS.items(), key=lambda kv: -kv[1])
    lines = [f"{'name':<48} {'calls':>8} {'total s':>10} {'avg ms':>10}"]
    for name, total in rows:
        c = _COUNTS[name]
        lines.append(f"{name:<48} {c:>8} {total:>10.3f} {total / c * 1e3:>10.3f}")
    if reset:
        _TOTALS.clear()
        _COUNTS.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Capture a `torch.profiler` trace of the block (host activity, and the
    card's kernels and copies when `device` is a CUDA device) and write it
    under `log_dir` as a Chrome trace JSON, `trace_<ns>.json`, which
    chrome://tracing or Perfetto (ui.perfetto.dev) opens. Yields the
    profiler (`key_averages()` sums the events by name). The device goes
    through `resolve_device`: asking for `cuda` without a card raises."""
    from torch.profiler import ProfilerActivity, profile

    from ..device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))
