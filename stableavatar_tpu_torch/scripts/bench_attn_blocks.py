"""The flash grid's products alone (dots) and the port's K1 at the DiT
self-attention shape.

Counterpart of the JAX package's `scripts/bench_attn_blocks.py` (S3), at the
same B, N, L, D = 3, 12, 21504, 128 and CH = 10, timed with CUDA events:

- `dots`: `ops.probes.dots_probe` -- bf16(q . k^T) . v over all keys with no
  softmax, chained CH times as h = dots(h, h, h) (the values overflow
  within a few calls; the time does not depend on them), then the int8-QK
  version, bf16(int32(q8 . k8^T) >> 7) . v, CH calls on the same operands;
- `sweep`: the port's K1 (`flash_attention`), chained CH times, once.  The
  JAX script swept seven (bq, bk) pairs, VMEM tilings of its Pallas call;
  K1 has one tiling (128 query rows a block, 128-key tiles) and no knob
  for it, so the sweep is one line.

On the card: `python -m stableavatar_tpu_torch.scripts.bench_attn_blocks
[all|dots|sweep]`.
"""

from __future__ import annotations

import sys

import torch

from stableavatar_tpu_torch.ops.flash_attention import flash_attention
from stableavatar_tpu_torch.ops.probes import dots_probe
from stableavatar_tpu_torch.scripts import seconds_per_call

B, N, L, D = 3, 12, 21504, 128
FLOPS = 4 * B * N * L * L * D
CH = 10
DEVICE = "cuda"


def _randn(gen, shape):
    return torch.randn(shape, generator=gen, device=DEVICE)


def dots_chain(h, ch: int):
    """h [B*N, L, D] bf16 through `ch` bf16 dots, h = dots(h, h, h)."""
    for _ in range(ch):
        h = dots_probe(h, h, h)
    return h


def int8_dots_calls(q8, k8, v, ch: int):
    """`ch` int8-QK dots on the same operands, each output folded into a
    scalar as the JAX script does."""
    acc = torch.zeros((), device=v.device)
    for _ in range(ch):
        o = dots_probe(q8, k8, v, int8=True)
        acc = acc + o[:, :1, :1].float().sum()
    return acc


def dots_only() -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    h = _randn(gen, (B, L, N, D)).bfloat16().reshape(B * N, L, D)
    t = seconds_per_call(lambda: dots_chain(h, CH), CH)
    print(f"dots-only       : {t*1e3:8.2f} ms  {FLOPS/t/1e12:6.1f} TF/s", flush=True)


def int8_dots_only() -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q8 = (_randn(gen, (B * N, L, D)) * 10).to(torch.int8)
    k8 = (_randn(gen, (B * N, L, D)) * 10).to(torch.int8)
    v = _randn(gen, (B * N, L, D)).bfloat16()
    t = seconds_per_call(lambda: int8_dots_calls(q8, k8, v, CH), CH)
    print(f"int8QK dots-only: {t*1e3:8.2f} ms  {FLOPS/t/1e12:6.1f} TF/s", flush=True)


def sweep() -> None:
    """K1 at [B, L, N, D] chained CH times: the one tiling the port has."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q = _randn(gen, (B, L, N, D)).bfloat16()

    def run():
        h = q
        for _ in range(CH):
            h = flash_attention(h, h, h)
        return h

    with torch.no_grad():
        t = seconds_per_call(run, CH)
    print(f"K1 bq=  128 bk=  128: {t*1e3:8.2f} ms  {FLOPS/t/1e12:6.1f} TF/s", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which in ("all", "dots"):
        dots_only()
        int8_dots_only()
    if which in ("all", "sweep"):
        sweep()


if __name__ == "__main__":
    main()
