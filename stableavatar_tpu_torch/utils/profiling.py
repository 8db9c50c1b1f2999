"""Per-phase wall timing, device traces and the spans inside them (port of
`stableavatar_tpu/utils/profiling.py`).

`StepTimer`: on a CUDA device each phase ends with `torch.cuda.synchronize()`,
so the recorded wall time covers the device work the phase enqueued.
`device_trace`: a `torch.profiler` trace exported for chrome://tracing or
Perfetto (where the JAX package writes an xprof trace).
`span`: a named stretch of the program's work, which costs one flag check
unless a `torch.profiler` is recording.  Then it is a host range in that
profiler's trace, on the profiler's clock with every kernel; the spans of
the DiT path (`TIMED`) also take a pair of timing CUDA events on the
current stream, and the denoise sweep (`SWEEP`) the caching allocator's
calls into CUDA.  `span_device_ms()` and `span_allocator_calls()` read the
most recent profiled stretch once the profiler has stopped.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# The span names of the generation path: the StepTimer phases of
# `pipelines/long.py:generate_long` are "sa.<phase>"; around the caller's
# step_callback "sa.step_callback"; in `_sweep_step` "sa.window" (one
# window's whole iteration) and "sa.dit" (its DiT call); in
# `models/dit.py:dit_forward` "sa.prologue", "sa.block" and "sa.head"; in
# `apply_block` the branches "sa.self_attn", "sa.cross_attn" and "sa.ffn".
WINDOW = "sa.window"
# the spans that carry a pair of timing events: the DiT path
TIMED = frozenset((WINDOW, "sa.dit", "sa.prologue", "sa.block", "sa.self_attn", "sa.cross_attn",
                   "sa.ffn", "sa.head"))
# the span that counts the caching allocator's calls into CUDA
SWEEP = "sa.denoise_step"

# the host clock that stands in for device time where there are no events
_clock = time.perf_counter


class _Recorder:
    """The spans of the most recent profiled stretch, in one process.

    A stretch starts at the first span that opens while a profiler records
    after the last one ended: a span opened or closed with no profiler
    recording, `device_trace` started, or a reading was taken.  Timing
    events come from a pool that every stretch reuses."""

    def __init__(self):
        self.pool: List[torch.cuda.Event] = []
        self.reset()
        self.done = True

    def reset(self):
        # CUDA events where the process uses the card, the host clock otherwise
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.spans: List[tuple] = []  # (name, start, end): events or host seconds
        self.used = 0
        self.windows = 0
        self.alloc_calls = 0
        self.alloc_windows = 0  # "sa.window" spans inside SWEEP spans
        self.alloc_open = 0  # SWEEP spans open
        self.reading = None
        self.done = False

    def marker(self):
        if not self.cuda:
            return _clock()
        if self.used == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        ev = self.pool[self.used]
        self.used += 1
        ev.record()
        return ev

    def read(self):
        if _autograd_profiler._is_profiler_enabled:
            raise RuntimeError("the spans are read after the profiler has stopped")
        self.done = True
        if self.reading is None:
            if self.cuda and self.spans:
                torch.cuda.synchronize()
            ms: Dict[str, float] = defaultdict(float)
            for name, a, b in self.spans:
                ms[name] += a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
            self.reading = dict(ms)
        return self.reading


_RECORDER = _Recorder()


class _Off:
    """The shared span of a process with no profiler recording: it ends the
    recorder's stretch and does nothing else."""

    __slots__ = ()

    def __enter__(self):
        _RECORDER.done = True

    def __exit__(self, *exc):
        return False


_NOOP = _Off()


def _cuda_allocs() -> int:
    s = torch.cuda.memory_stats()
    return s.get("num_device_alloc", 0) + s.get("num_device_free", 0)


class _Span:
    __slots__ = ("name", "_range", "_start", "_calls")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _RECORDER
        if rec.done:
            rec.reset()
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        if self.name == SWEEP and rec.cuda:
            self._calls = _cuda_allocs()
            rec.alloc_open += 1
        if self.name == WINDOW:
            rec.windows += 1
            rec.alloc_windows += rec.alloc_open > 0
        if self.name in TIMED:
            self._start = rec.marker()
        return self

    def __exit__(self, *exc):
        rec = _RECORDER
        if self.name in TIMED:
            rec.spans.append((self.name, self._start, rec.marker()))
        if self.name == SWEEP and rec.cuda:
            rec.alloc_calls += _cuda_allocs() - self._calls
            rec.alloc_open -= 1
        self._range.__exit__(*exc)
        if not _autograd_profiler._is_profiler_enabled:
            rec.done = True  # the profiler stopped inside this span
        return False


def span(name: str):
    """A context manager that marks the enclosed work as `name` (module
    docstring).  With no profiler recording it is a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def span_device_ms() -> Tuple[Dict[str, float], int]:
    """(device milliseconds by span name, number of "sa.window" spans) of
    the most recent profiled stretch.  Each timed span counts from its start
    event to its end event, nested spans included; without CUDA events the
    host clock stands in.  Call it after the profiler has stopped: it waits
    for the events."""
    return dict(_RECORDER.read()), _RECORDER.windows


def span_allocator_calls() -> Optional[Tuple[int, int]]:
    """(the caching allocator's calls into CUDA, cudaMalloc and
    cudaFree, inside the stretch's "sa.denoise_step" spans; the "sa.window"
    spans inside them), or None where the stretch ran without the card."""
    _RECORDER.read()
    if not _RECORDER.cuda:
        return None
    return _RECORDER.alloc_calls, _RECORDER.alloc_windows


class StepTimer:
    """Records the wall-clock seconds of every run of each named phase, each
    run inside `span("sa." + name)`.

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
        with span("sa." + name):
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
    `logdir`.  The trace carries the program's `span`s as host ranges, and
    `span_device_ms()` reads them afterwards.  Without `logdir` it does
    nothing.  Yields the profiler (None without `logdir`)."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _RECORDER.done = True
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
