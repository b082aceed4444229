"""Profiling utilities (twin of `freegaussian_tpu/utils/profiling.py`): the
program's spans, the phase marks inside a training step and the counters
beside them, the nerfstudio `profiler.time_function` equivalent (which the
reference wraps every pipeline entry with, freegaussian_pipeline.py:52-174)
over the same span, and a `torch.profiler` trace capture.

Spans. `profile_section(name, **attrs)` times a block. Its wall time always
goes into the module's totals table, which `profiler_summary()` prints (the
JAX package's table). While recording is on it also keeps the span: its
name, start and end (`time.perf_counter_ns()`), the span open around it
(its parent), the chunk it belongs to (`set_chunk`: a training chunk's
first step) and its attributes. Recording is on while a `torch.profiler`
run is active or inside `recording()`. Under a profiler each span also
opens a host range `fg/<name>` (function scope, so that it stays off the
device's timeline), which sits on the profiler's own host timeline with the
operations it launches as its children. Recording off, a
span costs one flag check and the totals: no device call, no
synchronisation.

Marks. `mark(phase, device)` opens a phase of a training step (`PHASES`);
`mark("end", device)` closes the last. Inside a capture (`capture_marks`)
a mark is an external timing event, an event node of the CUDA graph, which
every replay records again; `add_graph_phases` reads the last replay's
times after a synchronisation the caller makes anyway. Outside a capture,
and only while recording, a mark is a timing event from a small pool on
the card (read by `flush_marks` once complete) or the host clock on the
CPU, where the operations are synchronous. A mark never touches data.

Counters. `add` and `put` keep numbers by name (and by key). The trainer
keeps the phase times (`step.phase_ms` by phase, `step.phase_steps`), the
replays and kernel nodes of each step graph (`step.replays`,
`step.kernel_nodes` by graph), at each chunk's end the field kernels'
live rows and the rows of the blocks they run (`field.live_rows`,
`field.block_rows`), and for each refinement inside a chunk its counts
and device time (`refine.count`; `refine.split`, `refine.dup`,
`refine.culled`, `refine.alive`, `refine.dropped` and `refine.device_ms`
by the refinement's step), timed between two `stamp`s.

`recorded()` returns the spans and counters as plain Python data. CUDA work
is asynchronous: a span times what the host does in it (on the card, the
enqueueing), the marks time the device."""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PHASES = ("forward", "loss", "backward", "optimizer", "bookkeeping")
END = "end"

_TOTALS: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_SPANS: List[Dict[str, Any]] = []
_COUNTERS: Dict[str, Any] = {}
_OPEN: List[Dict[str, Any]] = []  # the open spans, innermost last
_IDS = itertools.count()
_RECORDING = 0  # depth of `recording()` blocks
_CHUNK: Optional[int] = None
_SINK: Optional[list] = None  # the marks of the step being captured
_STEP: Optional[list] = None  # the eager marks of the step under way
_UNREAD: List[list] = []  # eager steps on the card whose events are not read yet
_POOL: List[torch.cuda.Event] = []


def enabled() -> bool:
    """Whether spans, marks and counters are being recorded."""
    return _RECORDING > 0 or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans, eager marks and counters inside the block, without a
    profiler; `recorded()` and `profiler_summary()` read them."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def set_chunk(first_step: Optional[int]) -> None:
    """The chunk identifier the next spans carry (the chunk's first step;
    None outside training)."""
    global _CHUNK
    _CHUNK = first_step


class profile_section:
    """`with profile_section(name, **attrs) as span:` times the block (see
    the module's docstring); `span.note(**attrs)` adds attributes known
    only inside it."""

    __slots__ = ("name", "attrs", "t0", "span", "fn")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.span = None
        self.fn = None

    def __enter__(self):
        if enabled():
            if _autograd_profiler._is_profiler_enabled:
                # a function-scope range: `record_function`'s user scope is
                # mirrored on the device as an annotation spanning the
                # kernels it launched, which a device trace reads as busy time
                self.fn = torch._C._profiler._RecordFunctionFast(f"fg/{self.name}")
                self.fn.__enter__()
            self.span = {
                "name": self.name, "id": next(_IDS), "parent": _OPEN[-1]["id"] if _OPEN else None,
                "chunk": _CHUNK, "start_ns": 0, "end_ns": None, "attrs": self.attrs,
            }
            _SPANS.append(self.span)
            _OPEN.append(self.span)
        self.t0 = time.perf_counter_ns()
        if self.span is not None:
            self.span["start_ns"] = self.t0
        return self

    def note(self, **attrs) -> None:
        if self.span is not None:
            self.attrs.update(attrs)

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _TOTALS[self.name] += (t1 - self.t0) * 1e-9
        _COUNTS[self.name] += 1
        if self.span is not None:
            self.span["end_ns"] = t1
            if _OPEN and _OPEN[-1] is self.span:
                _OPEN.pop()
            if self.fn is not None:
                self.fn.__exit__(*exc)
        return False


def time_function(fn):
    """Decorator: each call is a span named by the function's qualname."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with profile_section(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapped


def add(name: str, value: float, key: Optional[str] = None) -> None:
    """Add `value` to counter `name` (at `key`, when given)."""
    if key is None:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value
    else:
        table = _COUNTERS.setdefault(name, {})
        table[key] = table.get(key, 0) + value


def put(name: str, value: float, key: Optional[str] = None) -> None:
    """Set counter `name` (at `key`, when given) to `value`."""
    if key is None:
        _COUNTERS[name] = value
    else:
        _COUNTERS.setdefault(name, {})[key] = value


def _add_phases(ms: Dict[str, float], weight: float) -> None:
    for phase, v in ms.items():
        add("step.phase_ms", v * weight, key=phase)
    add("step.phase_steps", weight)


def _phase_ms(marks: list, elapsed) -> Optional[Dict[str, float]]:
    """ms of each phase between consecutive marks [(phase, stamp), ...]
    that open with the first phase and close with END; None otherwise."""
    if not marks or marks[0][0] != PHASES[0] or marks[-1][0] != END:
        return None
    out: Dict[str, float] = {}
    for (phase, a), (_, b) in zip(marks, marks[1:]):
        out[phase] = out.get(phase, 0.0) + elapsed(a, b)
    return out


@contextlib.contextmanager
def capture_marks(into: list):
    """The marks made inside the block (a step under CUDA-graph capture)
    are appended to `into` as (phase, external timing event): the graph's
    own event nodes."""
    global _SINK
    outer, _SINK = _SINK, into
    try:
        yield into
    finally:
        _SINK = outer


def mark(phase: str, device: torch.device) -> None:
    """Open `phase` of the step on `device` (END closes the step)."""
    global _STEP
    if _SINK is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        _SINK.append((phase, ev))
        return
    if not enabled():
        return
    if phase == PHASES[0]:
        _STEP = []
    elif _STEP is None:
        return  # recording began inside this step
    if device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            _STEP = None  # a capture not made through `capture_marks`
            return
        stamp = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
        stamp.record()
    else:
        stamp = time.perf_counter_ns()
    _STEP.append((phase, stamp))
    if phase == END:
        marks, _STEP = _STEP, None
        if isinstance(stamp, int):
            ms = _phase_ms(marks, lambda a, b: (b - a) * 1e-6)
            if ms is not None:
                _add_phases(ms, 1.0)
        else:
            _UNREAD.append(marks)


def flush_marks() -> None:
    """Add the eager steps whose events are complete to the phase counters
    and return their events to the pool; call it after a synchronisation
    the loop makes anyway (an incomplete step waits for the next call)."""
    global _UNREAD
    waiting = []
    for marks in _UNREAD:
        if not marks[-1][1].query():
            waiting.append(marks)
            continue
        ms = _phase_ms(marks, lambda a, b: a.elapsed_time(b))
        if ms is not None and enabled():
            _add_phases(ms, 1.0)
        _POOL.extend(ev for _, ev in marks)
    _UNREAD = waiting


def stamp(device: torch.device):
    """A point on `device`'s timeline, as an eager mark takes it: a timing
    event from the pool recorded on the card's current stream, or the host
    clock (ns) on the CPU. `elapsed_ms` reads a pair, `release` returns
    stamps that will not be read."""
    if device.type != "cuda":
        return time.perf_counter_ns()
    ev = _POOL.pop() if _POOL else torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b) -> float:
    """ms from stamp `a` to stamp `b`, once both are complete (after a
    synchronisation the caller makes anyway); their events go back to the
    pool."""
    if isinstance(a, int):
        return (b - a) * 1e-6
    ms = a.elapsed_time(b)
    release(a, b)
    return ms


def release(*stamps) -> None:
    """Return stamps that will not be read to the pool."""
    _POOL.extend(s for s in stamps if not isinstance(s, int))


def graph_phases(marks: list) -> Optional[Dict[str, float]]:
    """ms of each phase in a step graph's last replay, from the marks its
    capture made (`capture_marks`); call it once the replay is complete."""
    return _phase_ms(marks, lambda a, b: a.elapsed_time(b))


def add_graph_phases(marks: list, replays: int) -> None:
    """Add a step graph's last replay's phases, weighted by `replays`, to
    the phase counters (while recording)."""
    if replays and enabled():
        ms = graph_phases(marks)
        if ms is not None:
            _add_phases(ms, float(replays))


def recorded(reset: bool = False) -> Dict[str, Any]:
    """{"spans": [...], "counters": {...}} as plain Python data. A span is
    {"name", "id", "parent", "chunk", "start_ns", "end_ns", "attrs"}, its
    parent the id of the span open around it (or None); spans still open
    are left out (a reset keeps them for their ends). `reset` clears
    both."""
    spans = [dict(s, attrs=dict(s["attrs"])) for s in _SPANS if s["end_ns"] is not None]
    counters = {k: dict(v) if isinstance(v, dict) else v for k, v in _COUNTERS.items()}
    if reset:
        _clear_recorded()
    return {"spans": spans, "counters": counters}


def _clear_recorded() -> None:
    global _STEP, _UNREAD
    _SPANS[:] = [s for s in _SPANS if s["end_ns"] is None]
    _COUNTERS.clear()
    _STEP = None
    _UNREAD = []


def profiler_summary(reset: bool = False) -> str:
    """The totals table (the JAX package's), then, when any were recorded,
    the step's phases (device ms a step) and the other counters. `reset`
    clears the table and everything recorded."""
    rows = sorted(_TOTALS.items(), key=lambda kv: -kv[1])
    lines = [f"{'name':<48} {'calls':>8} {'total s':>10} {'avg ms':>10}"]
    for name, total in rows:
        c = _COUNTS[name]
        lines.append(f"{name:<48} {c:>8} {total:>10.3f} {total / c * 1e3:>10.3f}")
    steps = _COUNTERS.get("step.phase_steps", 0)
    if steps:
        lines.append(f"{'step phase':<48} {'steps':>8} {'total ms':>10} {'ms a step':>10}")
        for phase in PHASES:
            ms = _COUNTERS["step.phase_ms"].get(phase, 0.0)
            lines.append(f"{phase:<48} {steps:>8g} {ms:>10.3f} {ms / steps:>10.3f}")
    for name, v in sorted(_COUNTERS.items()):
        if name.startswith("step.phase_"):
            continue
        for key, value in (sorted(v.items()) if isinstance(v, dict) else [(None, v)]):
            label = name if key is None else f"{name}[{key}]"
            lines.append(f"{label[:48]:<48} {value:>30g}")
    if reset:
        _TOTALS.clear()
        _COUNTS.clear()
        _clear_recorded()
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Capture a `torch.profiler` trace of the block (host activity with the
    program's `fg/...` spans, and the card's kernels and copies when
    `device` is a CUDA device) and write it under `log_dir` as a Chrome
    trace JSON, `trace_<ns>.json`, which chrome://tracing or Perfetto
    (ui.perfetto.dev) opens. Yields the profiler (`key_averages()` sums the
    events by name). The device goes through `resolve_device`: asking for
    `cuda` without a card raises."""
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
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))
