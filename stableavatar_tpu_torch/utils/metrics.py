"""Metrics logging (port of `stableavatar_tpu/utils/metrics.py`): a JSONL
sink that is always available, plus a TensorBoard event writer when
`tensorboardX` or torch's SummaryWriter is importable."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, logdir: str, run_name: str = "Talking_Face"):
        os.makedirs(logdir, exist_ok=True)
        self.jsonl_path = os.path.join(logdir, f"{run_name}.metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        for factory in (self._tbx, self._torch_tb):
            try:
                self._tb = factory(logdir)
                break
            except ImportError:
                continue

    @staticmethod
    def _tbx(logdir):
        from tensorboardX import SummaryWriter

        return SummaryWriter(logdir)

    @staticmethod
    def _torch_tb(logdir):
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
