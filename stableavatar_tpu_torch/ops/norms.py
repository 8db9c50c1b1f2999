"""Normalisations with fp32 internals (port of `stableavatar_tpu/ops/norms.py`).

Reductions run in fp32 and the result is cast back to the input dtype.
`rms_norm` multiplies its weight after the cast back (reference
`WanRMSNorm`); `layer_norm` applies weight and bias in fp32 before it;
`t5_rms_norm` (umT5) scales x by the fp32 rsqrt rounded to x's dtype, then
casts to the weight's dtype before the weight multiplies.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-5):
    xf = x.float()
    normed = (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    if weight is not None:
        normed = normed * weight
    return normed


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        normed = normed * weight.float()
    if bias is not None:
        normed = normed + bias.float()
    return normed.to(x.dtype)


def t5_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """T5-style RMSNorm, no mean subtraction (reference `T5LayerNorm`)."""
    xf = x.float()
    normed = x * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps).to(x.dtype)
    return weight * normed.to(weight.dtype)
