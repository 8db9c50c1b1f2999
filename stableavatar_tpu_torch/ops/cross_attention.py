"""Dual-context cross-attention: kernel K5.

Port of `stableavatar_tpu/ops/cross_attention.py`:
out = attn(q, k1, v1) + attn(q, k2, v2) with a separate softmax per context
(text L1 = 512, CLIP image L2 = 257 at the Wan token budgets).  On a CUDA
tensor it launches the hand-written Hopper kernel (`csrc/cross_attention.cu`,
an online softmax per segment with two accumulators); on a CPU tensor it
runs `_dual_plain`, the two-call form of the JAX package's `_dual_reference`.

The TPU kernel normalises P per segment before one bf16 P.V product; the
Hopper kernel divides by the row sums at the end, so the two agree up to
bf16 rounding of P (the chip check holds it to rel-L2 1e-2 / max-abs 6e-2
in bf16).  Inference only: no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.flash_attention import (
    LOG2E,
    _check,
    _flash_fwd_plain,
)

launch_counts = {"dual_context": 0}


def _dual_plain(q, k1, v1, k2, v2, scale):
    """attn(q, k1, v1) + attn(q, k2, v2): two plain softmax attentions (each
    one key block, i.e. an exact softmax), summed in fp32."""
    a = _flash_fwd_plain(q.float(), k1.float(), v1.float(), scale=scale, block_k=k1.shape[1])
    b = _flash_fwd_plain(q.float(), k2.float(), v2.float(), scale=scale, block_k=k2.shape[1])
    return (a + b).to(q.dtype)


def _dual_cuda(q, k1, v1, k2, v2, scale):
    b, lq, n, d = q.shape
    l1, l2 = k1.shape[1], k2.shape[1]
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernel takes 64 or 128")
    _check("q", q, torch.bfloat16)
    for name, t, l in (("k1", k1, l1), ("v1", v1, l1), ("k2", k2, l2), ("v2", v2, l2)):
        _check(name, t, torch.bfloat16, (b, l, n, d))
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    out = torch.empty_like(q)
    cuda_lib.launch(
        "sa_dual_context", q.data_ptr(), k1.data_ptr(), v1.data_ptr(),
        k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
        b, lq, l1, l2, n, d, float(scale * LOG2E),
    )
    launch_counts["dual_context"] += 1
    return out


def dual_context_attention(
    q: torch.Tensor,   # [B, Lq, N, D]
    k1: torch.Tensor,  # [B, L1, N, D]
    v1: torch.Tensor,
    k2: torch.Tensor,  # [B, L2, N, D]
    v2: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """attn(q,k1,v1) + attn(q,k2,v2): the K5 kernel for CUDA tensors, the
    plain two-call version for CPU tensors."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.is_cuda:
        return _dual_cuda(q, k1, v1, k2, v2, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no dual-context attention path for device {q.device}")
    return _dual_plain(q, k1, v1, k2, v2, scale)
