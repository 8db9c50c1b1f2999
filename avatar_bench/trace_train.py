"""The device trace of train steps, with each device operation's launch.

`Tracer` is `trace.Tracer` that also keeps, for every kernel, copy and fill,
the host time of the runtime call that launched it (matched by the
profiler's correlation id), and leaves the device-side copies of host
ranges (user annotations) out of the device's operations.  With the host
ranges the run opens around a part of the step, `TrainTrace.launched_s`
gives the device seconds of the work that part launched.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import List

from avatar_bench import trace


@dataclasses.dataclass
class TrainTrace(trace.Trace):
    launched: List[float] = dataclasses.field(default_factory=list)  # host s of each device op's launch

    def launched_s(self, name: str) -> float:
        """Device seconds of the kernels, copies and fills launched while
        the host was inside a range called `name`."""
        spans = sorted((s, e) for n, s, e in self.host if n == name)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for s, _ in merged]
        total = 0.0
        for (_, s, e), t in zip(self.device, self.launched):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                total += e - s
        return total


class Tracer(trace.Tracer):
    def stop(self, steps: int) -> TrainTrace:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        device, host, corr, launches = [], [], [], {}
        for ev in self.prof.profiler.kineto_results.events():
            start = ev.start_ns() * 1e-9
            span = (ev.name(), start, start + ev.duration_ns() * 1e-9)
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():
                    device.append(span)
                    corr.append(ev.correlation_id())
            elif ev.device_type() == DeviceType.CPU:
                host.append(span)
                c = ev.correlation_id()
                if c and (c not in launches or start < launches[c]):
                    launches[c] = start
        self.prof = None
        return TrainTrace(device=device, host=host, window_s=window_s, steps=steps,
                          launched=[launches.get(c, float("nan")) for c in corr])
