"""The traced window: `torch.profiler` over the device and the host, read
into the device's busy time (the union of its own events' intervals), the
kernels' device time by name, and the longest idle gaps with the host
operation that was running through each.

The busy share copies `profile_serve.py:_device_window`'s choice of events
(only the device's own: kernels, copies, sets), summed here as an interval
union so that overlapping events count once.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch


class Window:
    def __init__(self, device):
        self.device = device
        self.window_s = 0.0
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def result(self) -> dict:
        from torch.autograd import DeviceType

        dev_events: List[Tuple[float, float, str]] = []
        host_events: List[Tuple[float, float, str]] = []
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.device_type == DeviceType.CUDA:
                dev_events.append((tr.start, tr.end, ev.name))
            elif ev.device_type == DeviceType.CPU and ev.cpu_parent is None:
                host_events.append((tr.start, tr.end, ev.name))
        return summarize(dev_events, host_events, self.window_s)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(dev_events, host_events, window_s: float) -> dict:
    """busy_s, per-kernel device seconds, the top device operations and the
    idle gaps summed by the top-level host operation that covers each gap's
    middle (event times in microseconds)."""
    busy = union([(s, e) for s, e, _ in dev_events])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name: Dict[str, float] = {}
    for s, e, name in dev_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    hosts = sorted(host_events)
    starts = [h[0] for h in hosts]
    reach = []  # the latest end among the events started so far, and its index
    for i, (_, he, _) in enumerate(hosts):
        reach.append((he, i) if not reach or he > reach[-1][0] else reach[-1])
    idle: Dict[str, float] = {}
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid) - 1
        name = "python (no traced host operation)"
        if k >= 0 and reach[k][0] >= mid:
            name = hosts[reach[k][1]][2]
        idle[name] = idle.get(name, 0.0) + length * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernel_s": by_name,
        "device_events": len(dev_events),
        "breakdown": {"device_ops": [[n[:120], s] for n, s in top_ops], "idle_gaps": [[n[:120], s] for n, s in top_gaps]},
    }
