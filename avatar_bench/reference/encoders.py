"""The conditioning encoders in float32: the Wan2.1 VAE's causal encoder, the
CLIP ViT-H/14 visual tower (features after its 31st block) and
wav2vec2-base.  `cfg` objects are the configuration file's "vae", "clip"
and "wav2vec" groups."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from avatar_bench.reference.common import attention, layer_norm, linear

# ---------------------------------------------------------------------------
# VAE encoder (causal 3-D convolutions, time kernel 3, streamed in chunks of
# 4 frames after the first frame alone, the last frames of each conv's input
# carried into the next chunk)
# ---------------------------------------------------------------------------


def _norm(x, p):
    n = torch.sqrt((x * x).sum(dim=1, keepdim=True)).clamp_min(1e-12)
    return x / n * float(p["scale"]) * p["gamma"].float().reshape(1, -1, 1, 1, 1)


def _conv(p, x, stride=1, padding=0):
    conv = F.conv3d if x.dim() == 5 else F.conv2d
    return conv(x, p["w"].float(), p["b"].float(), stride=stride, padding=padding)


class _Carry:
    """The frames each causal conv carries from one chunk into the next, in
    the order the convs run; zeros before the first chunk."""

    def __init__(self, caches=None):
        self.caches, self.out, self.i = caches, [], 0

    def take(self, x, keep):
        if self.caches is None:
            prev = x.new_zeros((*x.shape[:2], keep, *x.shape[3:]))
        else:
            prev = self.caches[self.i]
        self.out.append(torch.cat([prev, x], 2)[:, :, -keep:])
        self.i += 1
        return prev


def _causal(p, x, carry, keep=2, stride=(1, 1, 1)):
    x = torch.cat([carry.take(x, keep), x], 2)
    sp = (p["w"].shape[3] - 1) // 2
    return _conv(p, x, stride=stride, padding=(0, sp, sp))


def _res(p, x, carry):
    h = _conv(p["shortcut"], x) if "shortcut" in p else x
    y = _causal(p["conv1"], F.silu(_norm(x, p["norm1"])), carry)
    y = _causal(p["conv2"], F.silu(_norm(y, p["norm2"])), carry)
    return y + h


def _frames(x):
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _unframes(x, b, t):
    return x.reshape(b, t, *x.shape[1:]).transpose(1, 2)


def _mid_attention(p, x):
    b, c, t, h, w = x.shape
    y = _frames(_norm(x, p["norm"]))
    qkv = _conv(p["qkv"], y).reshape(b * t, 3 * c, h * w).transpose(1, 2)
    q, k, v = (z[:, :, None] for z in qkv.chunk(3, dim=-1))
    out = attention(q, k, v)[:, :, 0].transpose(1, 2).reshape(b * t, c, h, w)
    return x + _unframes(_conv(p["proj"], out), b, t)


def _downsample(p, x, carry, temporal, first):
    b, _, t = x.shape[:3]
    x = _unframes(_conv(p["conv"], F.pad(_frames(x), (0, 1, 0, 1)), stride=2), b, t)
    if temporal:
        if first:
            carry.take(x, 1)  # the first frame passes; it is carried
        else:
            x = torch.cat([carry.take(x, 1), x], 2)
            x = _conv(p["time_conv"], x, stride=(2, 1, 1))
    return x


def _encode_chunk(p, cfg, x, carry, first):
    x = _causal(p["conv1"], x, carry)
    bi = 0
    levels = len(cfg["dim_mult"])
    for i in range(levels):
        for _ in range(cfg["num_res_blocks"]):
            x = _res(p["down"][bi], x, carry)
            bi += 1
        if i != levels - 1:
            x = _downsample(p["down"][bi], x, carry, cfg["temporal_downsample"][i], first)
            bi += 1
    x = _res(p["mid1"], x, carry)
    x = _mid_attention(p["mid_attn"], x)
    x = _res(p["mid2"], x, carry)
    return _causal(p["head_conv"], F.silu(_norm(x, p["head_norm"])), carry)


def vae_encode(params, cfg, video):
    """video [B, 3, 1 + 4n, H, W] in [-1, 1] -> normalised posterior mean
    [B, z, 1 + n, H/8, W/8]."""
    carry = _Carry()
    parts = [_encode_chunk(params["encoder"], cfg, video[:, :, :1].float(), carry, True)]
    for s in range(1, video.shape[2], 4):
        carry = _Carry(carry.out)
        parts.append(_encode_chunk(params["encoder"], cfg, video[:, :, s:s + 4].float(), carry,
                                   False))
    z = _conv(params["conv1"], torch.cat(parts, 2))[:, :cfg["z_dim"]]
    mean = torch.as_tensor(cfg["latent_mean"], device=z.device).reshape(1, -1, 1, 1, 1)
    std = torch.as_tensor(cfg["latent_std"], device=z.device).reshape(1, -1, 1, 1, 1)
    return (z - mean) / std


# ---------------------------------------------------------------------------
# CLIP visual tower
# ---------------------------------------------------------------------------


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] antialiased Keys-cubic (a = -0.5) resampling weights,
    as `jax.image.resize(method="cubic")` computes them in float32."""
    inv = np.float32(1.0) / (np.float32(n_out) / np.float32(n_in))
    width = max(inv, np.float32(1.0))
    centre = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(centre[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / width
    k = ((1.5 * x - 2.5) * x) * x + 1.0
    k = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, k)
    k = np.where(x >= 2.0, 0.0, k).astype(np.float32)
    total = k.sum(axis=0, keepdims=True)
    k = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 k / np.where(total != 0, total, 1), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return np.where(inside[None, :], k, 0.0).astype(np.float32).T


def clip_features(params, cfg, image):
    """image [B, 3, H, W] in [-1, 1] -> features [B, 257, 1280] after the 31st
    of 32 blocks, un-normalised."""
    s, p = cfg["image_size"], cfg["patch_size"]
    h, w = image.shape[-2:]
    wh = torch.as_tensor(_cubic_weights(h, s), device=image.device)
    ww = torch.as_tensor(_cubic_weights(w, s), device=image.device)
    x = torch.einsum("oh,bchw,pw->bcop", wh, image.float(), ww) * 0.5 + 0.5
    mean = torch.as_tensor(cfg["image_mean"], device=x.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(cfg["image_std"], device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    b, g = x.shape[0], s // p
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
    x = linear(params["patch_embedding"], x)
    x = torch.cat([params["cls_embedding"].float().expand(b, 1, -1), x], 1)
    x = layer_norm(x + params["pos_embedding"].float(), params["pre_norm"], cfg["eps"])
    d, heads = x.shape[-1], cfg["vision_heads"]
    for bp in params["blocks"][:-1]:
        h_ = layer_norm(x, bp["norm1"], cfg["eps"])
        qkv = linear(bp["attn"]["qkv"], h_).reshape(b, -1, 3, heads, d // heads)
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, -1, d)
        x = x + linear(bp["attn"]["proj"], o)
        h_ = layer_norm(x, bp["norm2"], cfg["eps"])
        x = x + linear(bp["mlp"]["fc2"], F.gelu(linear(bp["mlp"]["fc1"], h_)))
    return x


# ---------------------------------------------------------------------------
# wav2vec2-base
# ---------------------------------------------------------------------------


def wav2vec_states(params, cfg, wav):
    """wav [S] raw 16 kHz samples -> last hidden states [1, T, 768], after the
    processor's zero-mean, unit-variance normalisation."""
    x = wav.float()[None]
    x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, keepdim=True, unbiased=False) + 1e-7)
    x = x[:, None]
    for i, (p, s) in enumerate(zip(params["conv_layers"], cfg["conv_strides"])):
        x = F.conv1d(x, p["w"].float(), stride=s)
        if i == 0:
            x = F.group_norm(x, x.shape[1], p["gn"]["w"].float(), p["gn"]["b"].float(), 1e-5)
        x = F.gelu(x)
    x = x.transpose(1, 2)
    fp = params["feature_projection"]
    x = linear(fp["proj"], layer_norm(x, fp["norm"], cfg["eps"]))
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(F.pad(x.transpose(1, 2), (k // 2, k // 2)), params["pos_conv"]["w"].float(),
                   params["pos_conv"]["b"].float(), groups=cfg["num_conv_pos_embedding_groups"])
    pos = pos.transpose(1, 2)
    if k % 2 == 0:
        pos = pos[:, :-1]
    x = layer_norm(x + F.gelu(pos), params["encoder_norm"], cfg["eps"])
    heads = cfg["num_heads"]
    b, t, h = x.shape
    for bp in params["blocks"]:
        a = bp["attn"]
        q, k_, v = (linear(a[n], x).reshape(b, t, heads, h // heads) for n in ("q", "k", "v"))
        x = layer_norm(x + linear(a["o"], attention(q, k_, v).reshape(b, t, h)), bp["norm1"],
                       cfg["eps"])
        ff = linear(bp["ffn"]["fc2"], F.gelu(linear(bp["ffn"]["fc1"], x)))
        x = layer_norm(x + ff, bp["norm2"], cfg["eps"])
    return x
