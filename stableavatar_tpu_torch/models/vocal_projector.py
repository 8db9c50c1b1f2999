"""Timestep-aware audio adapter ("vocal projector"), port of
`stableavatar_tpu/models/vocal_projector.py`, and the shared linear layer.

Parameters are nested dicts of tensors.  A linear is {"w": [d_out, d_in],
"b": [d_out]} (`nn.Linear` layout), or carries int8 weights: {"w": {"q",
"s"}} for storage quantisation, {"w8": {"q", "s"}} for W8A8 compute
(`utils/quantization.py`).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.norms import layer_norm, rms_norm
from stableavatar_tpu_torch.utils.quantization import int8_linear


# ---------------------------------------------------------------------------
# window split (host-side, static; copied from the JAX package)
# ---------------------------------------------------------------------------


def split_audio_sequence(audio_len: int, num_frames: int = 81):
    """Index ranges [start, end] (inclusive) per latent frame."""
    tokens_per_frame = audio_len / num_frames
    half_tokens = int(tokens_per_frame * 4 / 2)

    pos_indices = []
    for i in range(int((num_frames - 1) / 4) + 1):
        if i == 0:
            pos_indices.append(0)
        else:
            start_token = tokens_per_frame * ((i - 1) * 4 + 1)
            end_token = tokens_per_frame * (i * 4 + 1)
            center_token = int((start_token + end_token) / 2) - 1
            pos_indices.append(center_token)

    ranges = [[idx - half_tokens, idx + half_tokens] for idx in pos_indices]
    if len(ranges) > 1:
        ranges[0] = [-(half_tokens * 2 - ranges[1][0]), ranges[1][0]]
    return ranges


@lru_cache(maxsize=64)
def window_plan(
    audio_len: int, num_frames: int = 81, expand: int = 4
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Static gather plan: (gather_idx [F, Lw], mask [F, Lw], k_lens [F], Lw);
    in-bounds tokens left-aligned, zero right-padding."""
    ranges = split_audio_sequence(audio_len, num_frames)
    ranges = [[s - expand, e + expand] for s, e in ranges]
    lw = max(e - s + 1 for s, e in ranges)

    f = len(ranges)
    gather = np.zeros((f, lw), dtype=np.int32)
    mask = np.zeros((f, lw), dtype=np.float32)
    k_lens = np.zeros((f,), dtype=np.int32)
    for i, (s, e) in enumerate(ranges):
        valid_start = max(s, 0)
        valid_end = min(e, audio_len - 1)
        n_valid = max(valid_end - valid_start + 1, 0)
        k_lens[i] = n_valid
        idx = valid_start + np.arange(lw)
        gather[i] = np.clip(idx, 0, audio_len - 1)
        mask[i, :n_valid] = 1.0
    return gather, mask, k_lens, lw


def split_windows(audio: torch.Tensor, num_frames: int, expand: int = 4):
    """[B, L, C] audio tokens -> ([B, F, Lw, C] windows, k_lens [F] int32)."""
    b, l, c = audio.shape
    gather, mask, k_lens, lw = window_plan(l, num_frames, expand)
    idx = torch.as_tensor(gather.reshape(-1), dtype=torch.long, device=audio.device)
    win = audio.index_select(1, idx).reshape(b, gather.shape[0], lw, c)
    win = win * torch.as_tensor(mask, device=audio.device)[None, :, :, None].to(audio.dtype)
    return win, torch.as_tensor(k_lens, device=audio.device)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _linear(gen, d_in, d_out, bias=True, init="xavier", zero=False, device=None,
            dtype=torch.float32):
    """Linear params in nn.Linear layout [d_out, d_in]; same distributions as
    the JAX package's `_linear` (drawn from a torch.Generator)."""
    if zero:
        w = torch.zeros((d_out, d_in), device=device)
    elif init == "xavier":
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = torch.rand((d_out, d_in), generator=gen, device=device) * (2 * lim) - lim
    else:
        w = torch.randn((d_out, d_in), generator=gen, device=device) * 0.02
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device, dtype=dtype)
    return p


def _affine(dim, device, dtype):
    return {"w": torch.ones((dim,), device=device, dtype=dtype),
            "b": torch.zeros((dim,), device=device, dtype=dtype)}


def _ones(dim, device, dtype):
    return {"w": torch.ones((dim,), device=device, dtype=dtype)}


def _normal(gen, shape, std, device, dtype):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def apply_linear(p, x):
    """y = x W^T + b with the three weight forms (float, int8 storage, W8A8).

    The product is rounded to x's dtype before the bias is added, and the sum
    rounded again, as the JAX package's `x @ w + b` rounds in bf16 (a fused
    bias epilogue would round once)."""
    if "w8" in p:
        return int8_linear(x, p["w8"], p.get("b"))
    w = p["w"]
    if isinstance(w, dict):
        w = w["q"].to(x.dtype) * w["s"].to(x.dtype)
    y = F.linear(x, w.to(x.dtype))
    b = p.get("b")
    return y if b is None else y + b.to(x.dtype)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant rounded to like's dtype, as JAX's weak typing does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def gelu_tanh(x):
    """jax.nn.gelu(approximate=True) op for op, each rounded to x's dtype:
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))), x^3 = x * (x * x)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (x + _const(0.044715, x) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x):
    """jax.nn.silu op for op as XLA lowers it, each op rounded to x's dtype:
    x * (1 / (1 + exp(-x))).  F.silu rounds once, and differs in bf16.  In
    fp32 each op rounds to fp32 anyway and F.silu agrees to an ulp in one
    pass over memory instead of four (a train step's fp32 VAE encodes take
    17% longer op for op)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_exact(x):
    """jax.nn.gelu(approximate=False) op for op: 0.5 * x * erfc(-x * sqrt(1/2))."""
    return 0.5 * x * torch.special.erfc(-x * _const(math.sqrt(0.5), x))


def init_vocal_projector(gen, cfg, device="cuda", dtype=torch.float32):
    """Parameter tree of the vocal projector: 1B projects 768 -> vd in one
    linear (no bias) + LayerNorm; 14B in two, 768 -> audio_proj_hidden -> vd,
    each without bias and followed by a LayerNorm, no activation between."""
    vd = cfg.audio_proj_dim
    kw = dict(device=device, dtype=dtype)
    if cfg.audio_proj_hidden is None:
        p = {"proj": {"fc": _linear(gen, cfg.audio_in_dim, vd, bias=False, **kw),
                      "norm": _affine(vd, device, dtype)}}
    else:
        h = cfg.audio_proj_hidden
        p = {"proj": {"fc1": _linear(gen, cfg.audio_in_dim, h, bias=False, **kw),
                      "norm1": _affine(h, device, dtype),
                      "fc2": _linear(gen, h, vd, bias=False, **kw),
                      "norm": _affine(vd, device, dtype)}}

    def block():
        return {
            "norm3": _affine(vd, device, dtype),
            "cross_attn": {
                "q": _linear(gen, vd, vd, **kw),
                "k": _linear(gen, cfg.dim, vd, **kw),
                "v": _linear(gen, cfg.dim, vd, **kw),
                "o": _linear(gen, vd, vd, **kw),
                "norm_q": _ones(vd, device, dtype),
                "norm_k": _ones(vd, device, dtype),
            },
            "ffn": {"fc1": _linear(gen, vd, vd * 2, **kw),
                    "fc2": _linear(gen, vd * 2, vd, **kw)},
            "modulation": _normal(gen, (1, 6, vd), vd ** -0.5, device, dtype),
        }

    p["blocks"] = [block() for _ in range(cfg.vocal_num_layers)]
    p["final_head"] = {
        "final_proj": _linear(gen, vd, vd, **kw),
        "modulation": _normal(gen, (1, 2, vd), vd ** -0.5, device, dtype),
    }
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _vocal_cross_attention(p, x, latents, num_heads, num_frames, eps):
    """Audio queries attend to the DiT latent tokens of their own frame."""
    b, vd = x.shape[0], x.shape[-1]
    d = vd // num_heads
    q = rms_norm(apply_linear(p["q"], x), p["norm_q"]["w"], eps).to(x.dtype)
    k = rms_norm(apply_linear(p["k"], latents), p["norm_k"]["w"], eps).to(x.dtype)
    v = apply_linear(p["v"], latents).to(x.dtype)
    q = q.reshape(b * num_frames, -1, num_heads, d)
    k = k.reshape(b * num_frames, -1, num_heads, d)
    v = v.reshape(b * num_frames, -1, num_heads, d)
    out = attention(q, k, v).reshape(b, -1, vd)
    return apply_linear(p["o"], out)


def _vocal_block(p, x, e0, latents, num_heads, num_frames, eps):
    e = p["modulation"].to(e0.dtype) + e0
    e = [e[:, i : i + 1] for i in range(6)]

    temp = layer_norm(x, eps=eps) * (1 + e[1]) + e[0]
    x = x + temp * e[2]

    normed = layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=eps)
    x = x + _vocal_cross_attention(p["cross_attn"], normed, latents, num_heads, num_frames, eps)

    temp = layer_norm(x, eps=eps) * (1 + e[4]) + e[3]
    y = apply_linear(p["ffn"]["fc2"], gelu_tanh(apply_linear(p["ffn"]["fc1"], temp)))
    return x + y * e[5]


def apply_vocal_projector(params, cfg, vocal_embeddings, latents, e0, e,
                          video_sample_n_frames: int = 81):
    """Returns (vocal_context [B, F, Lw, vd], k_lens [F] int32)."""
    pp = params["proj"]
    if "fc" in pp:
        x = apply_linear(pp["fc"], vocal_embeddings)
    else:  # 14B: two stages
        x = apply_linear(pp["fc1"], vocal_embeddings)
        x = layer_norm(x, pp["norm1"]["w"], pp["norm1"]["b"], eps=1e-5)
        x = apply_linear(pp["fc2"], x)
    x = layer_norm(x, pp["norm"]["w"], pp["norm"]["b"], eps=1e-5)

    win, k_lens = split_windows(x, video_sample_n_frames, expand=4)
    b, f, lw, vd = win.shape
    x = win.reshape(b, f * lw, vd)
    for bp in params["blocks"]:
        x = _vocal_block(bp, x, e0, latents, cfg.vocal_num_heads, f, cfg.eps)

    hm = params["final_head"]["modulation"].to(e.dtype) + e[:, None]
    h0, h1 = hm[:, 0:1], hm[:, 1:2]
    x = apply_linear(params["final_head"]["final_proj"],
                     layer_norm(x, eps=cfg.eps) * (1 + h1) + h0)
    return x.reshape(b, f, lw, vd), k_lens
