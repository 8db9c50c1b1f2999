"""umT5-xxl text encoder, port of `stableavatar_tpu/models/t5.py`.

umT5 encoder with a relative position bias per block (`shared_pos=False`),
T5 attention without the 1/sqrt(d) scale, a gated tanh-GELU feed-forward and
T5 RMS norms.  The attention runs over 512 tokens at most: plain PyTorch
ops, no kernel (the JAX package leaves it to XLA too).  Linears are
`{"w": [d_out, d_in]}` without bias (`nn.Linear` layout).

bf16 rounds where the JAX package rounds: every `x @ w` returns the
activation dtype, the q.k logits are rounded to it before the fp32 bias and
softmax, the probabilities are rounded to it before P.V.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stableavatar_tpu_torch.config import T5Config
from stableavatar_tpu_torch.models.vocal_projector import _linear, apply_linear, gelu_tanh
from stableavatar_tpu_torch.ops.norms import t5_rms_norm


def relative_position_buckets(lq: int, lk: int, num_buckets: int = 32,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 relative position buckets [lq, lk] (host-side
    numpy, copied from the JAX package)."""
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)

    max_exact = nb // 2
    rel_pos_large = max_exact + (
        np.log(np.maximum(rel_pos, 1) / max_exact)
        / math.log(max_dist / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    rel_pos_large = np.minimum(rel_pos_large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, rel_pos_large)
    return rel_buckets


def _pos_bias(embedding: torch.Tensor, lq: int, lk: int, cfg) -> torch.Tensor:
    """[1, heads, lq, lk] additive bias from the bucket embedding table."""
    buckets = torch.as_tensor(relative_position_buckets(lq, lk, cfg.num_buckets, cfg.max_dist),
                              device=embedding.device)
    return embedding[buckets].permute(2, 0, 1)[None]


def init_t5(gen: torch.Generator, cfg: T5Config = T5Config(), device="cuda",
            dtype=torch.float32):
    """Random parameter tree drawn on `device` from `gen` (a generator on
    that device) with the JAX package's distributions, cast leaf by leaf to
    `dtype` (umT5-xxl is 11.4 GB in bf16, twice that in fp32)."""
    d, da, dff = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    kw = dict(bias=False, device=device, dtype=dtype)
    pos_std = (2 * cfg.num_buckets * cfg.num_heads) ** -0.5

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    def ones():
        return {"w": torch.ones((d,), device=device, dtype=dtype)}

    def block():
        p = {
            "norm1": ones(),
            "attn": {name: _linear(gen, *dims, **kw) for name, dims in
                     (("q", (d, da)), ("k", (d, da)), ("v", (d, da)), ("o", (da, d)))},
            "norm2": ones(),
            "ffn": {name: _linear(gen, *dims, **kw) for name, dims in
                    (("gate", (d, dff)), ("fc1", (d, dff)), ("fc2", (dff, d)))},
        }
        if not cfg.shared_pos:
            p["pos_emb"] = normal((cfg.num_buckets, cfg.num_heads), pos_std)
        return p

    params = {"token_embedding": normal((cfg.vocab, d), 1.0),
              "blocks": [block() for _ in range(cfg.num_layers)],
              "norm": ones()}
    if cfg.shared_pos:
        params["pos_emb"] = normal((cfg.num_buckets, cfg.num_heads), pos_std)
    return params


def _t5_attention(p, x, mask, pos_bias, cfg):
    """T5 attention: no scaling, additive fp32 bias, fp32 softmax, masked
    keys at float32's minimum."""
    b, l, _ = x.shape
    n = cfg.num_heads
    hd = cfg.dim_attn // n
    q = apply_linear(p["q"], x).reshape(b, l, n, hd)
    k = apply_linear(p["k"], x).reshape(b, l, n, hd)
    v = apply_linear(p["v"], x).reshape(b, l, n, hd)

    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    # products of x's dtype are exact in fp32; one rounding to x's dtype
    attn = torch.einsum("binc,bjnc->bnij", q.to(acc), k.to(acc)).to(x.dtype).to(acc)
    attn = attn + pos_bias.to(acc)
    if mask is not None:
        attn = attn.masked_fill((mask == 0)[:, None, None, :], torch.finfo(acc).min)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.einsum("bnij,bjnc->binc", attn.to(acc), v.to(acc)).to(x.dtype)
    return apply_linear(p["o"], out.reshape(b, l, n * hd))


def t5_encode(params, cfg, input_ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
    """input_ids [B, L] -> hidden states [B, L, dim] in the parameters' dtype."""
    x = params["token_embedding"][input_ids.long()]
    l = x.shape[1]

    shared_bias = _pos_bias(params["pos_emb"], l, l, cfg) if cfg.shared_pos else None
    for bp in params["blocks"]:
        bias = shared_bias if cfg.shared_pos else _pos_bias(bp["pos_emb"], l, l, cfg)
        h = t5_rms_norm(x, bp["norm1"]["w"], cfg.eps)
        x = x + _t5_attention(bp["attn"], h, attention_mask, bias, cfg)
        h = t5_rms_norm(x, bp["norm2"]["w"], cfg.eps)
        ffn = bp["ffn"]
        ff = apply_linear(ffn["fc1"], h) * gelu_tanh(apply_linear(ffn["gate"], h))
        x = x + apply_linear(ffn["fc2"], ff)
    return t5_rms_norm(x, params["norm"]["w"], cfg.eps)
