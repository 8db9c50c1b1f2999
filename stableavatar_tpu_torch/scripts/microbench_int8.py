"""Does a hand-written int8 wgmma GEMM run at ~2x bf16 on the H100?

Counterpart of the JAX package's `scripts/microbench_pallas_int8.py` (S1):
the same [M, K] . [K, N] product (21504 x 1536 . 1536 x 1536), chained CH
times with each output fed back as `a`, in bf16 (fp32 sums, bf16 out) and
in int8 (int32 sums, int8 out by a wrapping cast) through
`ops.probes.mm_probe` (`csrc/probes.cu`), timed with CUDA events
(`scripts.seconds_per_call`).  On the card, from the repository root:

    python -m stableavatar_tpu_torch.scripts.microbench_int8
"""

from __future__ import annotations

import torch

from stableavatar_tpu_torch.ops.probes import mm_probe
from stableavatar_tpu_torch.scripts import seconds_per_call

M, K, N = 21504, 1536, 1536  # K == N, so each output chains as the next `a`
CH = 20
DEVICE = "cuda"


def inputs(device=None, seed: int = 0):
    """(a16, b16, a8, b8): normal bf16 operands and their int8 versions,
    (x * 10) cast with truncation as the JAX script's `.astype(int8)`."""
    device = DEVICE if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    a16 = torch.randn((M, K), generator=gen, device=device).bfloat16()
    b16 = torch.randn((K, N), generator=gen, device=device).bfloat16()
    a8 = (a16.float() * 10).to(torch.int8)
    b8 = (b16.float() * 10).to(torch.int8)
    return a16, b16, a8, b8


def chained(a, b, epilogue: str, ch: int):
    """`ch` products, each output fed back as `a` (the JAX fori_loop)."""
    for _ in range(ch):
        a = mm_probe(a, b, epilogue)
    return a


def main() -> None:
    a16, b16, a8, b8 = inputs()
    flops = 2 * M * K * N
    t = seconds_per_call(lambda: chained(a16, b16, "bf16", CH), CH)
    print(f"CUDA bf16: {t*1e3:7.2f} ms  {flops/t/1e12:6.1f} TF/s")
    t = seconds_per_call(lambda: chained(a8, b8, "int8", CH), CH)
    print(f"CUDA int8: {t*1e3:7.2f} ms  {flops/t/1e12:6.1f} TOP/s")


if __name__ == "__main__":
    main()
