"""Probe scripts of the port, run on the card as
`python -m stableavatar_tpu_torch.scripts.<name>`: counterparts of the JAX
package's `scripts/microbench_pallas_int8.py` (S1),
`scripts/microbench_pallas_int8_variants.py` (S2) and
`scripts/bench_attn_blocks.py` (S3) on the kernels of `ops/probes.py`, and
of its `scripts/microbench_int8.py` (library GEMMs: bf16, int8 and W8A8
chains) as `microbench_int8_linear`.

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
