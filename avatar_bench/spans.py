"""The program's spans as the per-layer readers see them.

The program marks its work with spans (`stableavatar_tpu_torch/utils/
profiling.py:span`) while a profiler records: host ranges in the trace
(`Trace.host`, by name) and, for the DiT path, device milliseconds that its
recorder resolves from CUDA events after the traced sweep
(`span_device_ms`), with the caching allocator's calls into CUDA
inside the sweep (`span_allocator_calls`).  A program without them, or a
recorder that does not hold one "sa.window" span per window-step of the
trace, gives nothing to read: every function here returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from avatar_bench.trace import gaps


def _profiling(ctx):
    """The program's profiling module where the run was traced and it has
    the spans, else None."""
    if ctx.get("trace") is None or ctx.get("train"):
        return None
    try:
        from stableavatar_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "span_device_ms") else None


def device_ms(ctx) -> Optional[Dict[str, float]]:
    """Device milliseconds a window-step by span name, over the traced
    sweep's "sa.window" spans."""
    profiling = _profiling(ctx)
    if profiling is None:
        return None
    ms, windows = profiling.span_device_ms()
    if windows == 0 or windows != ctx["steps"]:
        return None
    return {name: v / windows for name, v in ms.items()}


def own_ms(ctx, outer: str, inner: Tuple[str, ...]) -> Optional[float]:
    """The device ms a window-step of `outer` less those of the spans
    `inner` nested in it."""
    ms = device_ms(ctx)
    if ms is None or outer not in ms or not all(n in ms for n in inner):
        return None
    return ms[outer] - sum(ms[n] for n in inner)


def allocator_calls(ctx) -> Optional[float]:
    """The caching allocator's calls into CUDA a window-step of the
    traced sweep."""
    profiling = _profiling(ctx)
    got = None if profiling is None else profiling.span_allocator_calls()
    if got is None or got[1] == 0 or got[1] != ctx["steps"]:
        return None
    return got[0] / got[1]


def _overlap(a: float, b: float, spans: List[Tuple[float, float]]) -> float:
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in spans)


def idle_split(ctx) -> Optional[Tuple[float, float]]:
    """(ms a window-step the card was idle while the host was inside an
    "sa.dit" span, ms a window-step it was idle with the host elsewhere):
    the gaps in the union of the device's operations within each traced
    "sa.denoise_step" span, extended to the sweep's last device operation
    (one that started inside the span), split by their overlap with the
    "sa.dit" host spans."""
    if device_ms(ctx) is None:
        return None
    t = ctx["trace"]
    sweeps = [(s, e) for n, s, e in t.host if n == "sa.denoise_step"]
    dit = [(s, e) for n, s, e in t.host if n == "sa.dit"]
    if not sweeps:
        return None
    in_dit = total = 0.0
    for a, b in sweeps:
        hi = max([b] + [e for _, s, e in t.device if a <= s < b])
        for g0, g1 in gaps(t.device, a, hi):
            total += g1 - g0
            in_dit += _overlap(g0, g1, dit)
    return 1e3 * in_dit / t.steps, 1e3 * (total - in_dit) / t.steps
