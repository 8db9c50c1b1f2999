"""Probe and host scripts of the port, run on the card as
`python -m stableavatar_tpu_torch.scripts.<name>`: counterparts of the JAX
package's `scripts/microbench_pallas_int8.py` (S1),
`scripts/microbench_pallas_int8_variants.py` (S2) and
`scripts/bench_attn_blocks.py` (S3) on the kernels of `ops/probes.py`, of
its `scripts/microbench_int8.py` (library GEMMs: bf16, int8 and W8A8
chains) as `microbench_int8_linear`, and of its host scripts
`bench_decode_overlap`, `bench_dit_step`, `profile_step_parts` and
`quality_curves` (each a `main(argv)` with `--device`, so the CPU tests run
them at tiny sizes).

Their timing replaces the JAX scripts' RPC-floor subtraction with CUDA
events: one warm-up run of the chained function, then one run between two
events, divided by the chain's length.
"""

from __future__ import annotations


def seconds_per_call(fn, ch: int) -> float:
    """Seconds per call of `fn`, a chain of `ch` calls on the card: one
    warm-up run, then one run between two CUDA events.  There is no CPU
    fallback: a measurement needs the card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the probe scripts time the card: CUDA is not available")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return max(start.elapsed_time(end) * 1e-3, 1e-9) / ch


def elapsed_s(fn, device) -> tuple:
    """(fn(), seconds) of one call: between two CUDA events on the card,
    the second recorded after fn has returned (so the time covers what fn
    waited for on the host too), by the host clock on the CPU."""
    import time

    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) * 1e-3
