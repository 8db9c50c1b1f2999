"""int8 weights: storage quantisation and W8A8 compute (port of
`stableavatar_tpu/utils/quantization.py`).

Linear weights are in `nn.Linear` layout [d_out, d_in] (the JAX package keeps
[d_in, d_out]), so every per-output-channel reduction runs over the last
axis here.  Rounding is torch.round, half to even like jnp.round.

- Storage: {"q": int8 [.., d_out, d_in], "s": fp16 [.., d_out, 1]},
  dequantised to the activation dtype at use.
- Compute (W8A8): {"q": int8 [d_out, d_in], "s": fp32 [d_out]}; the
  activation is quantised per row (dynamic absmax), the int8 product runs in
  `torch._int_mm` (int32 out) -- the JAX package leaves this product to XLA
  outside any Pallas kernel -- and the epilogue applies both scales.
"""

from __future__ import annotations

import torch


def quantize_weight(w: torch.Tensor):
    """[.., d_out, d_in] float -> {'q': int8, 's': fp16 scale per out-channel}."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.float16)}


def dequantize_weight(p, dtype=torch.bfloat16):
    return (p["q"].float() * p["s"].float()).to(dtype)


def quantize_weight_for_compute(w: torch.Tensor):
    """[.., d_out, d_in] float -> {'q': int8, 's': fp32 [.., d_out]}."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


# torch._int_mm on CUDA needs more than 16 rows
_INT_MM_MIN_ROWS = 17


def int8_linear(x: torch.Tensor, w8, b=None) -> torch.Tensor:
    """y = x @ W^T (+ b) with dynamic per-row int8 activations.

    x: [..., d_in] float; w8: {'q': int8 [d_out, d_in], 's': fp32 [d_out]}.
    """
    q = w8["q"]
    d_out, d_in = q.shape
    if x.is_cuda and (d_in % 8 or d_out % 8):
        raise ValueError(f"int8_linear on CUDA needs d_in, d_out multiples of 8, got {d_in}, {d_out}")
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8).reshape(-1, d_in)
    rows = xq.shape[0]
    if xq.is_cuda and rows < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros(_INT_MM_MIN_ROWS - rows, d_in)])
    y = torch._int_mm(xq, q.t())[:rows].reshape(*x.shape[:-1], d_out)
    y = (y.float() * sx * w8["s"].float()).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y
