"""Attention entry point with ragged-key (`k_lens`) semantics (port of
`stableavatar_tpu/ops/attention.py`).

Dispatch mirrors the JAX package: long-query attention on the accelerator
(`lq >= 2048` and `d % 64 == 0` on a CUDA tensor) goes to the flash kernels
K1 (`quant="none"`, differentiable through K4) / K2 (`quant="qk"`); every
other call takes the short-query path, plain PyTorch ops that repeat the JAX
package's XLA path (`jax.nn.dot_product_attention`, which also ignores
`quant`) with a key-length mask.  It serves the per-latent-frame vocal
attention, CLIP and wav2vec.

Shapes: q [B, Lq, N, D], k/v [B, Lk, N, D] -> [B, Lq, N, D].
"""

from __future__ import annotations

from typing import Optional

import torch

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
    quant: "none" | "qk" (| "qkv" | "qkpv") for the flash path; the
    short-query path ignores it.
    """
    if _use_flash(q) and quant != "none":
        # int8 paths: rope goes into the quantisation prep
        return flash_attention(q, k, v, k_lens=k_lens, scale=scale, rope=rope, quant=quant)
    if rope is not None:
        # one rotation pass per tensor before K1 or the short-query path, as
        # the JAX package's `attention()` does; `flash_attention(rope=)`
        # rotates both in one kernel pass (`rope_rotate`) instead
        dt = q.dtype
        q = rope_apply_split(q, rope).to(dt)
        k = rope_apply_split(k, rope).to(dt)
    if _use_flash(q):
        return flash_attention(q, k, v, k_lens=k_lens, scale=scale)
    return short_attention(q, k, v, k_lens=k_lens, scale=scale)


def _use_flash(q: torch.Tensor) -> bool:
    """The flash kernels take long-query calls on the card: the short-query
    path materialises [B, N, Lq, Lk] logits (66 GB at the DiT
    self-attention)."""
    return q.is_cuda and q.shape[1] >= 2048 and q.shape[3] % 64 == 0


def short_attention(q, k, v, *, k_lens=None, scale=None):
    """Short-query path, `jax.nn.dot_product_attention(implementation="xla")`
    step for step so that bf16 rounds where the JAX package rounds: fp32
    logits (bf16 products are exact in fp32) times the scale, masked keys at
    -0.7 * float32 max, softmax in fp32, probabilities rounded to v's dtype,
    P.V accumulated in fp32 and rounded once.  The [B, N, Lq, Lk] logits are
    small here (Lq < 2048)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    logits = torch.einsum("btnh,bsnh->bnts", q.to(acc), k.to(acc)) * scale
    if k_lens is not None:
        cols = torch.arange(k.shape[1], device=q.device)
        mask = (cols[None, :] < k_lens.to(q.device)[:, None])[:, None, None, :]
        logits = torch.where(mask, logits, -0.7 * torch.finfo(logits.dtype).max)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnts,bsnh->btnh", probs.to(acc), v.to(acc)).to(q.dtype)
