"""Per-phase wall timing and device traces (port of
`stableavatar_tpu/utils/profiling.py`).

`StepTimer`: on a CUDA device each phase ends with `torch.cuda.synchronize()`,
so the recorded wall time covers the device work the phase enqueued.
`device_trace`: a `torch.profiler` trace exported for chrome://tracing or
Perfetto (where the JAX package writes an xprof trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class StepTimer:
    """Records the wall-clock seconds of every run of each named phase.

    `device` is where the timed work runs.  Left as None, it is taken from
    the first run that times with it (`follow`): `generate_long` and `train`
    pass their models' device."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.history: Dict[str, List[float]] = defaultdict(list)

    def follow(self, device) -> "StepTimer":
        """Adopt `device` unless the caller named one."""
        if self.device is None:
            self.device = torch.device(device)
        return self

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.history[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": sum(v), "count": len(v), "mean_s": sum(v) / len(v)}
            for k, v in self.history.items()
        }


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Trace the enclosed work with `torch.profiler` -- CPU activity, and
    CUDA activity (every kernel launched, with its name) when the card is
    there -- and export it as a Chrome trace `trace_<pid>_<ns>.json` into
    `logdir`.  Without `logdir` it does nothing.  Yields the profiler (None
    without `logdir`)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
