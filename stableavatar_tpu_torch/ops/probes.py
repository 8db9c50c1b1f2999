"""Probes S1-S3: a GEMM and the flash grid's two products, alone.

Port of the Pallas kernels of the JAX package's probe scripts
(`scripts/microbench_pallas_int8.py:mm_pallas`,
`scripts/microbench_pallas_int8_variants.py:build` with its bodies
`k_requant`, `k_scaled`, `k_bf16`, and `scripts/bench_attn_blocks.py:
dots_only` / `int8_dots_only`), driven by the port's scripts in
`stableavatar_tpu_torch/scripts/`.  They answer, on this card, whether the
int8 tensor-core product runs at about twice bf16 inside a hand-written
kernel.

On a CUDA tensor each wrapper launches its kernel (`csrc/probes.cu` for the
GEMM; the dots are two instances of the wgmma flash forward template,
`csrc/flash_attention.cu`); on a CPU tensor it runs the plain PyTorch version beside it (`_mm_plain`,
`_dots_plain`).  A CUDA call the kernel does not take raises.

- `mm_probe(a, b, epilogue)`: a [M, K] . b [K, N], both row-major as in the
  JAX scripts.  "bf16": bf16 in, fp32 sums, bf16 out.  "int8": int8 in,
  int32 sums, int8 out by a wrapping (truncating) cast, as `.astype(int8)`
  does.  "requant": clip(acc >> 8, -127, 127).  "scaled": bf16(float(acc)
  * 0.0039).  The int8 epilogues are exact: the plain version sums in
  float64 on the card (|acc| <= K * 127^2, 2.5e7 at K = 1536, beyond fp32's
  2^24) and in int32 on the CPU.
- `dots_probe(q, k, v, int8)`: q, k, v [BH, L, D]; the sum over all keys of
  bf16(q . k^T) . v (q, k bf16) or of bf16(int32(q8 . k8^T) >> 7) . v (q, k
  int8), fp32 sums, bf16 out.  No softmax: the values of a chained call
  grow without bound, which the timing does not mind.
"""

from __future__ import annotations

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.flash_attention import _PLAIN_CHUNK_BYTES

EPILOGUES = ("bf16", "int8", "requant", "scaled")
# the JAX body's `k_scaled` factor (an fp32 constant)
SCALED_FACTOR = 0.0039

# kernel launches, counted where each wrapper launches its kernel
launch_counts = {"mm_probe_bf16": 0, "mm_probe_int8": 0, "mm_probe_requant": 0,
                 "mm_probe_scaled": 0, "dots_probe_bf16": 0, "dots_probe_int8": 0}


def _epilogue_plain(acc: torch.Tensor, epilogue: str) -> torch.Tensor:
    """The JAX bodies' epilogues on exact int64 sums."""
    if epilogue == "int8":
        return ((acc + 128) % 256 - 128).to(torch.int8)
    if epilogue == "requant":
        return torch.clamp(acc >> 8, -127, 127).to(torch.int8)
    return (acc.to(torch.float32) * SCALED_FACTOR).to(torch.bfloat16)


def _mm_plain(a: torch.Tensor, b: torch.Tensor, epilogue: str) -> torch.Tensor:
    """Plain `mm_probe`: fp32 sums for bf16, exact integer sums for int8."""
    if epilogue == "bf16":
        return (a.float() @ b.float()).to(torch.bfloat16)
    if a.is_cuda:
        acc = (a.double() @ b.double()).to(torch.int64)
    else:
        acc = (a.to(torch.int32) @ b.to(torch.int32)).to(torch.int64)
    return _epilogue_plain(acc, epilogue)


def mm_probe(a: torch.Tensor, b: torch.Tensor, epilogue: str = "bf16") -> torch.Tensor:
    """S1 / S2: a [M, K] . b [K, N] with one of `EPILOGUES` -> [M, N] (bf16
    for "bf16" and "scaled", int8 otherwise).  a and b are bf16 for "bf16"
    and int8 for the others."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    dtype = torch.bfloat16 if epilogue == "bf16" else torch.int8
    for name, x in (("a", a), ("b", b)):
        if x.dtype != dtype:
            raise TypeError(f"{name}: epilogue {epilogue!r} takes {dtype}, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{name}: expected a matrix, got shape {tuple(x.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _mm_plain(a, b, epilogue)
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(f"no mm_probe path for a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mm_probe: the kernel needs contiguous row-major a and b")
    if k % 64 or n % 16:
        raise ValueError(f"mm_probe: the kernel takes K % 64 == 0 and N % 16 == 0, got K {k}, "
                         f"N {n}")
    out_dtype = torch.bfloat16 if epilogue in ("bf16", "scaled") else torch.int8
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    cuda_lib.launch("sa_mm_probe", a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                    EPILOGUES.index(epilogue))
    launch_counts[f"mm_probe_{epilogue}"] += 1
    return out


def _dots_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, int8: bool) -> torch.Tensor:
    """Plain `dots_probe`, in chunks of queries.  int8 logits are integers
    below D * 127^2 < 2^24, exact in fp32; the shift is an arithmetic one."""
    bh, lq, d = q.shape
    qf, kt, vf = q.float(), k.float().transpose(1, 2), v.float()
    out = torch.empty((bh, lq, d), dtype=torch.float32, device=q.device)
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * bh * k.shape[1]))
    for q0 in range(0, lq, qc):
        s = qf[:, q0:q0 + qc] @ kt
        if int8:
            s = s.to(torch.int32) >> 7
        out[:, q0:q0 + qc] = s.to(torch.bfloat16).float() @ vf
    return out.to(torch.bfloat16)


def dots_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               int8: bool = False) -> torch.Tensor:
    """S3: q, k, v [BH, L, D] -> [BH, L, D] bf16, the flash grid's two
    products with no softmax.  q and k are bf16, or int8 with `int8`; v is
    bf16."""
    qk_dtype = torch.int8 if int8 else torch.bfloat16
    for name, x, dtype in (("q", q, qk_dtype), ("k", k, qk_dtype), ("v", v, torch.bfloat16)):
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if x.dim() != 3 or x.shape != q.shape:
            raise ValueError(f"{name}: expected [BH, L, D] like q {tuple(q.shape)}, got "
                             f"{tuple(x.shape)}")
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return _dots_plain(q, k, v, int8)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("dots_probe: q, k and v must lie on one CUDA device")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("dots_probe: the kernel needs contiguous tensors")
    bh, l, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernel takes 64 or 128")
    out = torch.empty((bh, l, d), dtype=torch.bfloat16, device=q.device)
    cuda_lib.launch("sa_dots_probe", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, l, d, int(int8))
    launch_counts["dots_probe_int8" if int8 else "dots_probe_bf16"] += 1
    return out
