"""Wav2Vec2 (base-960h) audio feature extractor, port of
`stableavatar_tpu/models/wav2vec.py`.

7-layer conv feature extractor (group norm on the first layer), feature
projection, grouped conv positional embedding and a post-LN transformer.
Activations are [B, L, C] at the public functions; the convolutions run
channels-first with F.conv1d.  Conv weights are [C_out, C_in/groups, k].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stableavatar_tpu_torch.models.vocal_projector import _affine, _linear, _normal, apply_linear
from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.norms import layer_norm


def init_wav2vec2(gen, cfg, device="cuda", dtype=torch.float32):
    h = cfg.hidden_size
    kw = dict(device=device, dtype=dtype)
    convs = []
    cin = 1
    for i, (cout, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        p = {"w": _normal(gen, (cout, cin, k), 0.02, device, dtype)}
        if i == 0:
            p["gn"] = _affine(cout, device, dtype)
        convs.append(p)
        cin = cout

    def block():
        return {
            "attn": {name: _linear(gen, h, h, **kw) for name in ("q", "k", "v", "o")},
            "norm1": _affine(h, device, dtype),
            "ffn": {"fc1": _linear(gen, h, cfg.ffn_dim, **kw),
                    "fc2": _linear(gen, cfg.ffn_dim, h, **kw)},
            "norm2": _affine(h, device, dtype),
        }

    groups = cfg.num_conv_pos_embedding_groups
    return {
        "conv_layers": convs,
        "feature_projection": {
            "norm": _affine(cfg.conv_dims[-1], device, dtype),
            "proj": _linear(gen, cfg.conv_dims[-1], h, **kw),
        },
        "pos_conv": {
            "w": _normal(gen, (h, h // groups, cfg.num_conv_pos_embeddings), 0.02, device, dtype),
            "b": torch.zeros((h,), device=device, dtype=dtype),
        },
        "encoder_norm": _affine(h, device, dtype),
        "blocks": [block() for _ in range(cfg.num_layers)],
    }


def _group_norm(x, w, b, num_groups, eps=1e-5):
    """x [B, C, L] channels-first; fp32 statistics over (group channels, L)."""
    bdim, c, l = x.shape
    xf = x.float().reshape(bdim, num_groups, c // num_groups, l)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(bdim, c, l)
    return (xf * w.float()[:, None] + b.float()[:, None]).to(x.dtype)


def feature_extractor(params, cfg, waveform: torch.Tensor):
    """waveform [B, S] -> [B, T, 512]."""
    x = waveform[:, None, :]
    for p, s in zip(params["conv_layers"], cfg.conv_strides):
        x = F.conv1d(x, p["w"].to(x.dtype), stride=s)
        if "gn" in p:
            x = _group_norm(x, p["gn"]["w"], p["gn"]["b"], x.shape[1])
        x = F.gelu(x)
    return x.transpose(1, 2)


def _encoder_block(p, x, num_heads, eps):
    b, l, h = x.shape
    hd = h // num_heads
    q = apply_linear(p["attn"]["q"], x).reshape(b, l, num_heads, hd) * (hd ** -0.5)
    k = apply_linear(p["attn"]["k"], x).reshape(b, l, num_heads, hd)
    v = apply_linear(p["attn"]["v"], x).reshape(b, l, num_heads, hd)
    o = attention(q, k, v, scale=1.0).reshape(b, l, h)
    x = x + apply_linear(p["attn"]["o"], o)
    x = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps)
    ff = apply_linear(p["ffn"]["fc2"], F.gelu(apply_linear(p["ffn"]["fc1"], x)))
    return layer_norm(x + ff, p["norm2"]["w"], p["norm2"]["b"], eps)


def wav2vec2_forward(params, cfg, waveform: torch.Tensor):
    """waveform [B, S] (16 kHz) -> last_hidden_state [B, T, hidden]."""
    feats = feature_extractor(params, cfg, waveform)
    fp = params["feature_projection"]
    x = layer_norm(feats, fp["norm"]["w"], fp["norm"]["b"], cfg.eps)
    x = apply_linear(fp["proj"], x)

    # grouped conv positional embedding: pad k/2 both sides, drop the last
    # element for even kernels (HF num_pad_remove)
    k = cfg.num_conv_pos_embeddings
    pos = F.conv1d(F.pad(x.transpose(1, 2), (k // 2, k // 2)),
                   params["pos_conv"]["w"].to(x.dtype), params["pos_conv"]["b"].to(x.dtype),
                   groups=cfg.num_conv_pos_embedding_groups).transpose(1, 2)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = x + F.gelu(pos)
    x = layer_norm(x, params["encoder_norm"]["w"], params["encoder_norm"]["b"], cfg.eps)
    for bp in params["blocks"]:
        x = _encoder_block(bp, x, cfg.num_heads, cfg.eps)
    return x


def normalize_waveform(waveform: torch.Tensor, eps: float = 1e-7):
    """Wav2Vec2Processor zero-mean / unit-variance normalisation."""
    mean = waveform.mean(dim=-1, keepdim=True)
    var = waveform.var(dim=-1, keepdim=True, unbiased=False)
    return (waveform - mean) / torch.sqrt(var + eps)
