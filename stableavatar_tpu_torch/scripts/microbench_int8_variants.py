"""The int8 GEMM's epilogues on the H100: requantised int8, scaled bf16, and
bf16 for comparison.

Counterpart of the JAX package's `scripts/microbench_pallas_int8_variants.py`
(S2): the same [21504, 1536] . [1536, 1536] product through
`ops.probes.mm_probe` with the bodies `k_requant` ("requant": clip(acc >>
8, -127, 127), chained CH times), `k_scaled` ("scaled": bf16(float(acc) *
0.0039)) and `k_bf16`, timed with CUDA events.  The JAX script ran
`k_requant` on three (bm, bn) tiles, VMEM choices of its Pallas call; the
port's kernel has one tile configuration (128 x 128 outputs a block,
`csrc/probes.cu`), so its tile loop is one line.  The JAX script builds but
never times `k_scaled` (its bf16 output cannot feed the int8 chain); this
one times it as CH unchained calls on the same operands.  On the card:

    python -m stableavatar_tpu_torch.scripts.microbench_int8_variants
"""

from __future__ import annotations

from stableavatar_tpu_torch.ops.probes import mm_probe
from stableavatar_tpu_torch.scripts import seconds_per_call
from stableavatar_tpu_torch.scripts.microbench_int8 import chained, inputs

M, K, N = 21504, 1536, 1536
CH = 200
# the port's one tile configuration (output rows x columns of a block)
TILE = (128, 128)


def scaled_calls(a8, b8, ch: int):
    """`ch` calls of the scaled epilogue on the same operands."""
    out = None
    for _ in range(ch):
        out = mm_probe(a8, b8, "scaled")
    return out


def main() -> None:
    a16, b16, a8, b8 = inputs()
    flops = 2 * M * K * N
    bm, bn = TILE
    print(f"(one tile configuration, {bm}x{bn}: the JAX script's 1024x512, 2688x768 and "
          "1024x1536 were TPU VMEM tiles)")
    t = seconds_per_call(lambda: chained(a8, b8, "requant", CH), CH)
    print(f"int8 requant {bm}x{bn}: {t*1e3:7.2f} ms  {flops/t/1e12:6.1f} TOP/s")
    t = seconds_per_call(lambda: scaled_calls(a8, b8, CH), CH)
    print(f"int8 scaled  {bm}x{bn}: {t*1e3:7.2f} ms  {flops/t/1e12:6.1f} TOP/s")
    t = seconds_per_call(lambda: chained(a16, b16, "bf16", CH), CH)
    print(f"bf16 {bm}x{bn}        : {t*1e3:7.2f} ms  {flops/t/1e12:6.1f} TF/s")


if __name__ == "__main__":
    main()
