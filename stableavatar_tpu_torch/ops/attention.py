"""Attention entry point with ragged-key (`k_lens`) semantics (port of
`stableavatar_tpu/ops/attention.py`).

Dispatch mirrors the JAX package: long-query attention on the accelerator
(`lq >= 2048` and `d % 64 == 0` on a CUDA tensor) goes to the flash kernels
K1 (`quant="none"`) / K2 (`quant="qk"`); every other call takes the
short-query path, PyTorch's scaled_dot_product_attention with a key-length
mask -- the port of the JAX package's XLA path, which also ignores `quant`.
It serves the per-latent-frame vocal attention, CLIP and wav2vec.

Shapes: q [B, Lq, N, D], k/v [B, Lk, N, D] -> [B, Lq, N, D].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stableavatar_tpu_torch.ops.flash_attention import flash_attention
from stableavatar_tpu_torch.ops.rope import rope_apply_split


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    k_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    rope: Optional[torch.Tensor] = None,
    quant: str = "none",
) -> torch.Tensor:
    """Scaled dot-product attention; keys at or past k_lens[b] are masked.

    rope: packed split-pair [L, D] table (q/k in split-pair layout).
    quant: "none" | "qk" (| "qkv" | "qkpv") for the flash path; the SDPA
    path ignores it.
    """
    if _use_flash(q):
        return flash_attention(q, k, v, k_lens=k_lens, scale=scale, rope=rope, quant=quant)
    if rope is not None:
        dt = q.dtype
        q = rope_apply_split(q, rope).to(dt)
        k = rope_apply_split(k, rope).to(dt)
    return sdpa_attention(q, k, v, k_lens=k_lens, scale=scale)


def _use_flash(q: torch.Tensor) -> bool:
    """The flash kernels take long-query calls on the card: SDPA's math path
    would materialise [B, N, Lq, Lk] logits at the DiT self-attention."""
    return q.is_cuda and q.shape[1] >= 2048 and q.shape[3] % 64 == 0


def sdpa_attention(q, k, v, *, k_lens=None, scale=None):
    """Short-query path: torch SDPA on [B, N, L, D] with a boolean key mask."""
    mask = None
    if k_lens is not None:
        cols = torch.arange(k.shape[1], device=q.device)
        mask = (cols[None, :] < k_lens.to(q.device)[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale,
    )
    return out.transpose(1, 2)
