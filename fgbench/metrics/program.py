"""The program's own record of the traced window: the spans, step phase
marks and counters of `freegaussian_tpu_torch/utils/profiling.py`, read
with `profiling.recorded()` in this process (the program records while
the window's profiler runs). Every reader gets None where there is nothing
to read: an untraced run, or a program that keeps no such record."""

from __future__ import annotations

from typing import Dict, List, Optional


def recorded(ctx) -> Optional[dict]:
    if not ctx.get("trace") or ctx.get("steps", 0) <= 0:
        return None
    try:
        from freegaussian_tpu_torch.utils import profiling

        rec = profiling.recorded()
    except (ImportError, AttributeError):
        return None
    if not rec.get("spans") and not rec.get("counters"):
        return None
    return rec


def phase_ms(ctx, phase: str) -> Optional[float]:
    """Device ms a step in `phase` of the step (between its marks)."""
    rec = recorded(ctx)
    if rec is None:
        return None
    counters = rec["counters"]
    steps = counters.get("step.phase_steps", 0)
    ms = counters.get("step.phase_ms", {}).get(phase)
    if not steps or ms is None:
        return None
    return ms / steps


def top_level(rec) -> Dict[object, List[dict]]:
    """The spans without a parent, by chunk, each chunk's in start order."""
    chunks: Dict[object, List[dict]] = {}
    for s in rec["spans"]:
        if s["parent"] is None and s["chunk"] is not None:
            chunks.setdefault(s["chunk"], []).append(s)
    for spans in chunks.values():
        spans.sort(key=lambda s: s["start_ns"])
    return chunks

