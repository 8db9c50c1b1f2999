"""The device trace of a window and its reduction to intervals.

`Tracer` wraps `torch.profiler` (CPU and CUDA activity) around part of a
run and keeps the result in memory: the device's operations as (name,
start_s, end_s) and the host's as the same, on the profiler's clock.
Everything below `Tracer` is plain arithmetic on such lists, so the CPU
tests can feed it synthetic intervals.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]  # name, start s, end s

# device operations that are copies or fills, not kernels
COPY = re.compile(r"^(Memcpy|Memset)|\bmemcpy\b|\bmemset\b", re.I)


def union_s(intervals: Sequence[Interval]) -> float:
    """Seconds covered by at least one interval."""
    total, end = 0.0, None
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: Sequence[Interval], start: float, stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop] that no interval covers."""
    out, cur = [], start
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > cur:
            out.append((cur, min(s, stop)))
        cur = max(cur, e)
        if cur >= stop:
            break
    if cur < stop:
        out.append((cur, stop))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    device: List[Interval]  # kernels, copies and fills
    host: List[Interval]  # host operations
    window_s: float  # host-clock length of the traced window
    steps: int  # window-steps or train steps inside it

    @property
    def kernels(self) -> List[Interval]:
        return [x for x in self.device if not COPY.search(x[0])]

    @property
    def busy_s(self) -> float:
        return union_s(self.device)

    def seconds(self, pattern: re.Pattern, exclude: Optional[re.Pattern] = None) -> float:
        """Device seconds of the kernels whose names match (and not `exclude`)."""
        return sum(e - s for n, s, e in self.kernels
                   if pattern.search(n) and not (exclude and exclude.search(n)))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation running at their middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        if self.device:
            lo = min(s for _, s, _ in self.device)
            hi = max(e for _, _, e in self.device)
        else:
            lo = hi = 0.0
        longest = sorted(gaps(self.device, lo, hi), key=lambda g: g[0] - g[1])[:top]
        idle = []
        for a, b in longest:
            mid = (a + b) / 2
            inside = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            idle.append([min(inside)[1] if inside else "host", b - a])
        return {"device_ops": [[n[:160], t] for n, t in ops], "idle_gaps": idle}


class Tracer:
    """Profile the work between `start()` and `stop()`; both synchronise."""

    def __init__(self):
        self.prof = None
        self.t0 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, steps: int) -> Trace:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        device, host = [], []
        # the profiler's raw events: building its FunctionEvents for some
        # hundred thousand kernels would take longer than the window
        for ev in self.prof.profiler.kineto_results.events():
            start = ev.start_ns() * 1e-9
            span = (ev.name(), start, start + ev.duration_ns() * 1e-9)
            if ev.device_type() == DeviceType.CUDA:
                device.append(span)
            elif ev.device_type() == DeviceType.CPU:
                host.append(span)
        self.prof = None
        return Trace(device=device, host=host, window_s=window_s, steps=steps)
