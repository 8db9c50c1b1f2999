"""Dual-context cross-attention: kernel K5.

Port of `stableavatar_tpu/ops/cross_attention.py`:
out = attn(q, k1, v1) + attn(q, k2, v2) with a separate softmax per context
(text L1 = 512, CLIP image L2 = 257 at the Wan token budgets).  On a CUDA
tensor it launches the hand-written Hopper kernel (`csrc/cross_attention.cu`:
wgmma and a TMA ring, two sweeps of each segment's keys: row statistics,
then the normalised P.V); on a CPU tensor it runs `_dual_plain`, the TPU
kernel's arithmetic (`_dual_body`).

The TPU kernel normalises P per segment, rounds it to the value dtype and
runs one P.V over both segments; `_dual_plain` and the Hopper kernel round
at the same points, so the kernel differs from them only by the order of
its fp32 sums (the chip check holds it to rel-L2 1e-2 / max-abs 6e-2 in
bf16).  Inference only: no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from stableavatar_tpu_torch.ops import cuda_lib
from stableavatar_tpu_torch.ops.flash_attention import (
    _PLAIN_CHUNK_BYTES,
    LOG2E,
    _acc_dtype,
    _check,
)

launch_counts = {"dual_context": 0}

# keys per K / V tile of the kernel (`csrc/cross_attention.cu`: k5::kBlockN);
# a segment's ragged last tile is masked, not skipped
KERNEL_BLOCK_K = 128


def _dual_plain(q, k1, v1, k2, v2, scale):
    """attn(q, k1, v1) + attn(q, k2, v2) as the TPU body `_dual_body`
    computes it: fp32 logits of both segments in the base-2 domain, an
    exact softmax per segment whose P is normalised by the reciprocal of its
    row sum and rounded to v's dtype, then one P.V over both segments summed
    in fp32 and rounded once; in chunks of queries."""
    b, lq, n, d = q.shape
    l1 = k1.shape[1]
    acc = _acc_dtype(q)
    qf = q.permute(0, 2, 1, 3).to(acc)
    kt = torch.cat([k1, k2], dim=1).permute(0, 2, 3, 1).to(acc)  # [B, N, D, L1 + L2]
    vc = torch.cat([v1, v2], dim=1).permute(0, 2, 1, 3)
    vf = vc.to(acc)
    out = torch.empty((b, n, lq, d), dtype=acc, device=q.device)
    qc = max(1, _PLAIN_CHUNK_BYTES // (4 * b * n * kt.shape[-1]))
    for q0 in range(0, lq, qc):
        s = (qf[:, :, q0:q0 + qc] @ kt) * (scale * LOG2E)
        p = []
        for seg in (s[..., :l1], s[..., l1:]):
            e = torch.exp2(seg - seg.amax(dim=-1, keepdim=True))
            p.append(e * (1.0 / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)))
        out[:, :, q0:q0 + qc] = torch.cat(p, dim=-1).to(vc.dtype).to(acc) @ vf
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _dual_cuda(q, k1, v1, k2, v2, scale):
    b, lq, n, d = q.shape
    l1, l2 = k1.shape[1], k2.shape[1]
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernel takes 64 or 128")
    if min(l1, l2) < 1:
        raise ValueError(f"contexts of {l1} and {l2} keys: the kernel takes at least one each")
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
