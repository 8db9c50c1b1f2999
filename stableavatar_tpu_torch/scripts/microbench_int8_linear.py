"""Does int8 pay for the DiT's linears on the H100?

Counterpart of the JAX package's `scripts/microbench_int8.py` (library
GEMMs, no Pallas): the same [21504, 1536] . [1536, 8960] product and its way
back ([21504, 8960] . [8960, 1536]), chained CH times as the JAX
`fori_loop` chains them, in three chains with the JAX script's arithmetic op
for op:

- bf16: `torch.matmul` in bf16 (fp32 sums, bf16 out) both ways;
- int8 (pure): `torch._int_mm` into int32, `(h >> 8)` cast to int8 with the
  wrap of `.astype(int8)`, both ways;
- W8A8 (dynamic): per-row absmax quantisation of the bf16 activation
  (`max|x| / 127`, `round(x / max(s, 1e-9))`), `torch._int_mm`, the int32
  sums times the row scale rounded to bf16, both ways -- the real linear
  layer's scheme (`utils/quantization.py:int8_linear`).

The weights b [K, N] and c [N, K] are kept in the `nn.Linear` layout the
port's linears use ([d_out, d_in], `wb = b^T`, `wc = c^T`) and multiplied
through their transposed views, the layout cuBLAS's int8 product takes.
Beside the chains, at the same shapes, the hand-written `mm_probe` (bf16 and
int8 with the wrapping epilogue; it reads b row-major), and at the DiT's own
linears (rows 3 x 21504: the CFG batch of one window; d_in -> d_out 1536 ->
1536, 1536 -> 8960, 8960 -> 1536) `int8_linear` against `F.linear` in bf16.
Times are CUDA-event means over a chain (`scripts.seconds_per_call`).  On
the card, from the repository root:

    python -m stableavatar_tpu_torch.scripts.microbench_int8_linear
"""

from __future__ import annotations

import json

import torch

from stableavatar_tpu_torch.ops.probes import mm_probe
from stableavatar_tpu_torch.scripts import seconds_per_call
from stableavatar_tpu_torch.utils.quantization import int8_linear, quantize_weight_for_compute

M, K, N = 21504, 1536, 8960
CH = 20  # chained iterations
DEVICE = "cuda"
# the DiT's linears at one window's CFG batch: rows, (d_in, d_out)
DIT_ROWS = 3 * 21504
DIT_LINEARS = ((1536, 1536), (1536, 8960), (8960, 1536))


def inputs(device=None, seed: int = 0):
    """(a16, wb16, wc16, a8, wb8, wc8): a [M, K] and the two weights [N, K],
    [K, N] in bf16, and their int8 versions, (x * 10) cast with the
    truncation of the JAX script's `.astype(int8)`."""
    device = DEVICE if device is None else device
    gen = torch.Generator(device=device).manual_seed(seed)
    a16 = torch.randn((M, K), generator=gen, device=device).bfloat16()
    wb16 = torch.randn((N, K), generator=gen, device=device).bfloat16()
    wc16 = torch.randn((K, N), generator=gen, device=device).bfloat16()
    a8, wb8, wc8 = ((x.float() * 10).to(torch.int8) for x in (a16, wb16, wc16))
    return a16, wb16, wc16, a8, wb8, wc8


def chain_bf16(a, wb, wc, ch: int):
    for _ in range(ch):
        a = torch.matmul(torch.matmul(a, wb.t()), wc.t())
    return a


def chain_int8(a, wb, wc, ch: int):
    for _ in range(ch):
        h8 = (torch._int_mm(a, wb.t()) >> 8).to(torch.int8)
        a = (torch._int_mm(h8, wc.t()) >> 8).to(torch.int8)
    return a


def quant_rows(x):
    """The JAX script's `q`: per-row absmax int8 and its fp32 scale."""
    s = x.abs().amax(dim=-1, keepdim=True).float() / 127.0
    xq = torch.round(x.float() / torch.clamp(s, min=1e-9)).to(torch.int8)
    return xq, s


def chain_w8a8(a, wb, wc, ch: int):
    for _ in range(ch):
        xq, s = quant_rows(a)
        h = (torch._int_mm(xq, wb.t()).float() * s).bfloat16()
        xq2, s2 = quant_rows(h)
        a = (torch._int_mm(xq2, wc.t()).float() * s2).bfloat16()
    return a


def probe_iteration(a, b, c, epilogue: str):
    """One iteration's two products through the hand-written GEMM (b, c
    row-major [K, N] and [N, K], as the kernel reads them)."""
    return mm_probe(mm_probe(a, b, epilogue), c, epilogue)


def main() -> dict:
    a16, wb16, wc16, a8, wb8, wc8 = inputs()
    flops = 2 * 2 * M * K * N  # two products an iteration
    res = {"card": torch.cuda.get_device_name(0)}
    for name, fn in (("chain_bf16", lambda: chain_bf16(a16, wb16, wc16, CH)),
                     ("chain_int8", lambda: chain_int8(a8, wb8, wc8, CH)),
                     ("chain_w8a8", lambda: chain_w8a8(a16, wb8, wc8, CH))):
        t = seconds_per_call(fn, CH)
        res[f"{name}_ms"] = t * 1e3
        print(f"torch {name[6:]:5s}: {t*1e3:8.3f} ms/iter  {flops/t/1e12:6.1f} T(FL)OP/s")
    b16, c16 = wb16.t().contiguous(), wc16.t().contiguous()
    b8, c8 = wb8.t().contiguous(), wc8.t().contiguous()
    for epi, (a, b, c) in (("bf16", (a16, b16, c16)), ("int8", (a8, b8, c8))):
        t = seconds_per_call(lambda: [probe_iteration(a, b, c, epi) for _ in range(CH)], CH)
        res[f"mm_probe_{epi}_ms"] = t * 1e3
        print(f"mm_probe {epi}: {t*1e3:8.3f} ms/iter  {flops/t/1e12:6.1f} T(FL)OP/s")
    del a16, wb16, wc16, a8, wb8, wc8, b16, c16, b8, c8
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for d_in, d_out in DIT_LINEARS:
        x = torch.randn((DIT_ROWS, d_in), generator=gen, device=DEVICE).bfloat16()
        w = torch.randn((d_out, d_in), generator=gen, device=DEVICE) * d_in ** -0.5
        bias = torch.randn((d_out,), generator=gen, device=DEVICE).bfloat16()
        w8, w16 = quantize_weight_for_compute(w), w.bfloat16()
        t8 = seconds_per_call(lambda: [int8_linear(x, w8, bias) for _ in range(CH)], CH)
        t16 = seconds_per_call(
            lambda: [torch.nn.functional.linear(x, w16, bias) for _ in range(CH)], CH)
        key = f"linear_{d_in}x{d_out}"
        res[f"{key}_int8_ms"], res[f"{key}_bf16_ms"] = t8 * 1e3, t16 * 1e3
        print(f"[{DIT_ROWS}, {d_in}] -> {d_out}: int8_linear {t8*1e3:.3f} ms, "
              f"F.linear {t16*1e3:.3f} ms ({t8 / t16:.2f}x)")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
