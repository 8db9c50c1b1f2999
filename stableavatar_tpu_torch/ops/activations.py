"""The tanh GELU of the feed-forward branches.

`gelu_tanh` is `jax.nn.gelu(approximate=True)` as the JAX package computes
it: nine elementwise ops, each rounded to x's dtype.  On a CPU tensor it
runs them in PyTorch (`_gelu_tanh_plain`).  On a CUDA tensor it launches
`sa_gelu_tanh` (`csrc/elementwise.cu`): one read and one write of x in
place of nine PyTorch passes, rounding where they round, so equal to them
bit for bit, and written over x (every caller hands it the product it just
made); it takes bf16 and fp32, contiguous and 16-byte aligned, and any
other CUDA tensor raises.  Under autograd x is kept and the backward is
`sa_gelu_tanh_bwd`, equal bit for bit to autograd through the nine ops on
the card.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from stableavatar_tpu_torch.ops import cuda_lib

launch_counts = {"gelu_tanh": 0, "gelu_tanh_bwd": 0}

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded to like's dtype, as JAX's weak typing does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _gelu_tanh_plain(x):
    """jax.nn.gelu(approximate=True) op for op, each rounded to x's dtype:
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))), x^3 = x * (x * x)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# the two constants of the chain as `_const` rounds them, by dtype (exact in fp32)
CONSTS = {dt: (float(torch.tensor(math.sqrt(2 / math.pi), dtype=dt)),
               float(torch.tensor(0.044715, dtype=dt))) for dt in _KERNEL_DTYPES}


def _check_cuda(name, t, dtype=None):
    if t.dtype not in _KERNEL_DTYPES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"{name}: the kernel takes bf16 or fp32 like x, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")


def _gelu_tanh_cuda(x, out):
    """`sa_gelu_tanh` (one launch): out = gelu_tanh(x); out may be x."""
    _check_cuda("x", x)
    _check_cuda("out", out, x.dtype)
    if x.numel():
        cuda_lib.launch("sa_gelu_tanh", x.data_ptr(), out.data_ptr(), x.numel(),
                        int(x.dtype == torch.float32), *CONSTS[x.dtype])
        launch_counts["gelu_tanh"] += 1
    return out


def _gelu_tanh_bwd_cuda(x, g):
    """`sa_gelu_tanh_bwd` (one launch): x's gradient given gelu_tanh(x)'s, g."""
    _check_cuda("x", x)
    _check_cuda("g", g, x.dtype)
    dx = torch.empty_like(x)
    if x.numel():
        cuda_lib.launch("sa_gelu_tanh_bwd", x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(),
                        int(x.dtype == torch.float32), *CONSTS[x.dtype])
        launch_counts["gelu_tanh_bwd"] += 1
    return dx


class _GeluTanh(torch.autograd.Function):
    """gelu_tanh on the card under autograd: x is saved and the backward
    recomputes the chain from it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_tanh_cuda(x, torch.empty_like(x))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _gelu_tanh_bwd_cuda(x, g.contiguous())


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), rounded as the JAX package rounds it.
    x is consumed: on the card, where autograd records no graph through the
    call, the result is written over it."""
    if not x.is_cuda:
        return _gelu_tanh_plain(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluTanh.apply(x)
    return _gelu_tanh_cuda(x, x)
