"""Per-phase wall timing (port of `stableavatar_tpu/utils/profiling.py:StepTimer`).

On a CUDA device each phase ends with `torch.cuda.synchronize()`, so the
recorded wall time covers the device work the phase enqueued.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


class StepTimer:
    """Records the wall-clock seconds of every run of each named phase."""

    def __init__(self, device="cpu"):
        self.sync = torch.device(device).type == "cuda"
        self.history: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.history[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": sum(v), "count": len(v), "mean_s": sum(v) / len(v)}
            for k, v in self.history.items()
        }
