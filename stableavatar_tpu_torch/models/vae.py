"""Causal 3D VAE (Wan2.1_VAE), port of `stableavatar_tpu/models/vae.py`.

Channels-first inside ([B, C, T, H, W], F.conv3d / F.conv2d); conv weights
are [C_out, C_in, kt, kh, kw] / [C_out, C_in, kh, kw].  The streaming
protocol is the JAX package's explicit cache carry (`_Cache`): every causal
conv keeps the last 2 input frames (1 for the strided temporal downsample),
a zero cache on the first chunk equals the reference's zero padding, and
the temporal upsample skips its time conv on the first chunk ('Rep').
Chunks run in a Python loop where the JAX package scans.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from stableavatar_tpu_torch.models.vocal_projector import silu
from stableavatar_tpu_torch.ops.attention import short_attention

CACHE_T = 2


def channel_rms_norm(x, gamma, scale):
    """L2-normalise over channels (eps 1e-12) * scale * gamma, fp32 inside."""
    xf = x.float()
    norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True))
    g = gamma.float().reshape(1, -1, *([1] * (x.dim() - 2)))
    return (xf / torch.clamp(norm, min=1e-12) * float(scale) * g).to(x.dtype)


class _Cache:
    """Per-conv caches threaded in traversal order.  With no incoming caches
    (the first chunk) every slot starts as zeros, exactly as the JAX package
    runs its first chunk on zero caches."""

    def __init__(self, caches: Optional[List[torch.Tensor]] = None):
        self.caches_in = caches
        self.caches_out: List[torch.Tensor] = []
        self.idx = 0

    def step(self, x_t: torch.Tensor, keep: int) -> torch.Tensor:
        """Incoming cache of this conv; records the last `keep` frames of
        concat(cache, x) as its outgoing cache."""
        if self.caches_in is None:
            b, c, _, h, w = x_t.shape
            cache_in = x_t.new_zeros((b, c, keep, h, w))
        else:
            cache_in = self.caches_in[self.idx]
        self.caches_out.append(torch.cat([cache_in, x_t], dim=2)[:, :, -keep:])
        self.idx += 1
        return cache_in

    def step_zero(self, x_t: torch.Tensor, keep: int) -> None:
        b, c, _, h, w = x_t.shape
        self.caches_out.append(x_t.new_zeros((b, c, keep, h, w)))
        self.idx += 1


def _add_bias(p, y):
    """+ b in y's dtype after the product is rounded, as the JAX conv3d /
    conv2d add it (a bias passed into F.conv* is added before rounding)."""
    b = p.get("b")
    return y if b is None else y + b.to(y.dtype).reshape(1, -1, *([1] * (y.dim() - 2)))


def _conv3d(p, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    return _add_bias(p, F.conv3d(x, p["w"].to(x.dtype), stride=stride, padding=padding))


def _conv2d(p, x, stride=1, padding=0):
    return _add_bias(p, F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=padding))


def causal_conv3d(p, x, ctx: _Cache, stride=(1, 1, 1)):
    """CausalConv3d (time kernel 3): conv(concat(cache, x)), spatial SAME."""
    x = torch.cat([ctx.step(x, CACHE_T), x], dim=2)
    sp = (p["w"].shape[3] - 1) // 2
    return _conv3d(p, x, stride=stride, padding=(0, sp, sp))


def time_conv_stream(p, x, ctx: _Cache, stride_t=1):
    """Temporal-only causal conv (kernel (3,1,1)) of the resamplers; the
    strided (downsample) variant keeps one cached frame."""
    keep = 1 if stride_t == 2 else CACHE_T
    x = torch.cat([ctx.step(x, keep), x], dim=2)
    return _conv3d(p, x, stride=(stride_t, 1, 1))


def residual_block(p, x, ctx: _Cache):
    h = _conv3d(p["shortcut"], x) if "shortcut" in p else x
    y = silu(channel_rms_norm(x, p["norm1"]["gamma"], p["norm1"]["scale"]))
    y = causal_conv3d(p["conv1"], y, ctx)
    y = silu(channel_rms_norm(y, p["norm2"]["gamma"], p["norm2"]["scale"]))
    y = causal_conv3d(p["conv2"], y, ctx)
    return y + h


def _frames(x):
    """[B, C, T, H, W] -> [B*T, C, H, W]"""
    b, c, t, h, w = x.shape
    return x.transpose(1, 2).reshape(b * t, c, h, w)


def _unframes(x, b, t):
    bt, c, h, w = x.shape
    return x.reshape(b, t, c, h, w).transpose(1, 2)


def attention_block(p, x):
    """Single-head per-frame spatial attention."""
    b, c, t, h, w = x.shape
    y = _frames(channel_rms_norm(x, p["norm"]["gamma"], p["norm"]["scale"]))
    qkv = _conv2d(p["qkv"], y).reshape(b * t, 3 * c, h * w).transpose(1, 2)
    q, k, v = qkv.chunk(3, dim=-1)
    # [B*T, HW, 1 head, C], rounded where jax.nn.dot_product_attention rounds
    out = short_attention(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
    out = _conv2d(p["proj"], out.transpose(1, 2).reshape(b * t, c, h, w))
    return x + _unframes(out, b, t)


def resample(p, x, ctx: _Cache, mode: str, first_chunk: bool):
    b, c, t, h, w = x.shape
    if mode == "upsample3d" and not first_chunk:
        y = time_conv_stream(p["time_conv"], x, ctx)  # [B, 2C, T, H, W]
        # interleave the two C-sized halves along time
        x = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5).reshape(b, c, 2 * t, h, w)
        t = 2 * t
    elif mode == "upsample3d" and first_chunk:
        ctx.step_zero(x, CACHE_T)

    if mode in ("upsample2d", "upsample3d"):
        xs = _frames(x).repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        x = _unframes(_conv2d(p["conv"], xs, padding=1), b, t)
    elif mode in ("downsample2d", "downsample3d"):
        xs = F.pad(_frames(x), (0, 1, 0, 1))
        x = _unframes(_conv2d(p["conv"], xs, stride=2), b, t)

    if mode == "downsample3d":
        if first_chunk:
            ctx.step(x, 1)
        else:
            x = time_conv_stream(p["time_conv"], x, ctx, stride_t=2)
    return x


def encoder_apply(p, x, ctx: _Cache, cfg, first_chunk: bool):
    x = causal_conv3d(p["conv1"], x, ctx)
    bi = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks):
            x = residual_block(p["down"][bi], x, ctx)
            bi += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temporal_downsample[i] else "downsample2d"
            x = resample(p["down"][bi], x, ctx, mode, first_chunk)
            bi += 1
    x = residual_block(p["mid1"], x, ctx)
    x = attention_block(p["mid_attn"], x)
    x = residual_block(p["mid2"], x, ctx)
    x = silu(channel_rms_norm(x, p["head_norm"]["gamma"], p["head_norm"]["scale"]))
    return causal_conv3d(p["head_conv"], x, ctx)


def decoder_apply(p, x, ctx: _Cache, cfg, first_chunk: bool):
    x = causal_conv3d(p["conv1"], x, ctx)
    x = residual_block(p["mid1"], x, ctx)
    x = attention_block(p["mid_attn"], x)
    x = residual_block(p["mid2"], x, ctx)
    temporal_upsample = tuple(reversed(cfg.temporal_downsample))
    bi = 0
    for i in range(len(cfg.dim_mult)):
        for _ in range(cfg.num_res_blocks + 1):
            x = residual_block(p["up"][bi], x, ctx)
            bi += 1
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if temporal_upsample[i] else "upsample2d"
            x = resample(p["up"][bi], x, ctx, mode, first_chunk)
            bi += 1
    x = silu(channel_rms_norm(x, p["head_norm"]["gamma"], p["head_norm"]["scale"]))
    return causal_conv3d(p["head_conv"], x, ctx)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _conv_p(gen, cin, cout, k, device, dtype, zero=False):
    fan_in = cin * int(np.prod(k))
    lim = 1.0 / np.sqrt(fan_in)
    if zero:
        w = torch.zeros((cout, cin, *k), device=device)
    else:
        w = torch.rand((cout, cin, *k), generator=gen, device=device) * (2 * lim) - lim
    return {"w": w.to(dtype), "b": torch.zeros((cout,), device=device, dtype=dtype)}


def init_vae(gen, cfg, device="cuda", dtype=torch.float32):
    """Random VAE parameters (the JAX package's `init_vae` distributions)."""
    def norm(dim):
        return {"gamma": torch.ones((dim,), device=device, dtype=dtype), "scale": float(np.sqrt(dim))}

    def res(cin, cout):
        p = {"norm1": norm(cin), "conv1": _conv_p(gen, cin, cout, (3, 3, 3), device, dtype),
             "norm2": norm(cout), "conv2": _conv_p(gen, cout, cout, (3, 3, 3), device, dtype)}
        if cin != cout:
            p["shortcut"] = _conv_p(gen, cin, cout, (1, 1, 1), device, dtype)
        return p

    def attn(dim):
        return {"norm": norm(dim), "qkv": _conv_p(gen, dim, dim * 3, (1, 1), device, dtype),
                "proj": _conv_p(gen, dim, dim, (1, 1), device, dtype, zero=True)}

    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    enc = {"conv1": _conv_p(gen, 3, dims[0], (3, 3, 3), device, dtype), "down": []}
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        c = cin
        for _ in range(cfg.num_res_blocks):
            enc["down"].append(res(c, cout))
            c = cout
        if i != len(cfg.dim_mult) - 1:
            rp = {"conv": _conv_p(gen, cout, cout, (3, 3), device, dtype)}
            if cfg.temporal_downsample[i]:
                rp["time_conv"] = _conv_p(gen, cout, cout, (3, 1, 1), device, dtype)
            enc["down"].append(rp)
    d = dims[-1]
    enc.update(mid1=res(d, d), mid_attn=attn(d), mid2=res(d, d), head_norm=norm(d),
               head_conv=_conv_p(gen, d, cfg.z_dim * 2, (3, 3, 3), device, dtype))

    ddims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(reversed(cfg.dim_mult))]
    temporal_upsample = tuple(reversed(cfg.temporal_downsample))
    dec = {"conv1": _conv_p(gen, cfg.z_dim, ddims[0], (3, 3, 3), device, dtype),
           "mid1": res(ddims[0], ddims[0]), "mid_attn": attn(ddims[0]),
           "mid2": res(ddims[0], ddims[0]), "up": []}
    for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
        c = cin // 2 if i in (1, 2, 3) else cin  # upsampling halves channels
        for _ in range(cfg.num_res_blocks + 1):
            dec["up"].append(res(c, cout))
            c = cout
        if i != len(cfg.dim_mult) - 1:
            rp = {"conv": _conv_p(gen, cout, cout // 2, (3, 3), device, dtype)}
            if temporal_upsample[i]:
                rp["time_conv"] = _conv_p(gen, cout, cout * 2, (3, 1, 1), device, dtype)
            dec["up"].append(rp)
    dec.update(head_norm=norm(ddims[-1]),
               head_conv=_conv_p(gen, ddims[-1], 3, (3, 3, 3), device, dtype))
    return {
        "encoder": enc,
        "decoder": dec,
        "conv1": _conv_p(gen, cfg.z_dim * 2, cfg.z_dim * 2, (1, 1, 1), device, dtype),
        "conv2": _conv_p(gen, cfg.z_dim, cfg.z_dim, (1, 1, 1), device, dtype),
    }


# ---------------------------------------------------------------------------
# streaming encode / decode
# ---------------------------------------------------------------------------


def _latent_stats(cfg, like):
    mean = torch.as_tensor(cfg.latent_mean, device=like.device, dtype=like.dtype)
    std = torch.as_tensor(cfg.latent_std, device=like.device, dtype=like.dtype)
    return mean[None, :, None, None, None], std[None, :, None, None, None]


def encode_video(params, video, cfg, chunks_per_step: Optional[int] = None):
    """video [B, 3, T, H, W] (T = 1 + 4n) -> normalised mu [B, z, 1+n, H/8, W/8]:
    the first frame alone, then groups of `chunks_per_step` 4-frame chunks
    (chunk boundaries are invisible through the caches)."""
    return _encode_moments(params, video, cfg, chunks_per_step)[0]


def encode_video_sample(params, video, cfg, noise=None, generator=None,
                        chunks_per_step: Optional[int] = None, rows=None):
    """Like `encode_video` but SAMPLES the posterior, as the reference trainer
    does: mu (normalised) + exp(0.5 * clip(log_var, -30, 20)) * N(0, 1), with
    log_var in raw latent units (the as-built quirk the JAX package keeps).
    `noise` (same shape as mu) is used as given; otherwise it is drawn from
    `generator` -- with `rows` = (global batch, slice), at the global
    batch's size, keeping the slice that `video` holds."""
    mu, logvar = _encode_moments(params, video, cfg, chunks_per_step)
    if noise is None:
        shape = mu.shape if rows is None else (rows[0], *mu.shape[1:])
        noise = torch.randn(shape, generator=generator, device=mu.device, dtype=mu.dtype)
        noise = noise if rows is None else noise[rows[1]]
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mu + std * noise.to(device=mu.device, dtype=mu.dtype)


def _encode_moments(params, video, cfg, chunks_per_step: Optional[int] = None):
    """(normalised mu, raw log_var) of the posterior, each [B, z, 1+n, h, w]."""
    b, _, t, h, w = video.shape
    if (t - 1) % 4:
        raise ValueError(f"T must be 1+4n, got {t}")
    if chunks_per_step is None:
        chunks_per_step = max(1, min(4, (4 * 384 * 384) // max(h * w, 1)))
    enc = params["encoder"]
    ctx = _Cache(None)
    parts = [encoder_apply(enc, video[:, :, :1], ctx, cfg, first_chunk=True)]
    caches = ctx.caches_out
    step = 4 * max(1, chunks_per_step)
    for s in range(1, t, step):
        ctx = _Cache(caches)
        parts.append(encoder_apply(enc, video[:, :, s : s + step], ctx, cfg, first_chunk=False))
        caches = ctx.caches_out
    z = _conv3d(params["conv1"], torch.cat(parts, dim=2))
    mu, logvar = z[:, : cfg.z_dim], z[:, cfg.z_dim :]
    mean, std = _latent_stats(cfg, mu)
    return (mu - mean) / std, logvar


def _decode_segment(params, z_seg, caches, cfg, frames_per_step: int, first: bool,
                    out_uint8: bool = False):
    """One temporal segment of the streaming decode; returns (frames
    [B, 3, Ts, H, W], caches) so segments chain exactly."""
    mean, std = _latent_stats(cfg, z_seg)
    x = _conv3d(params["conv2"], z_seg * std + mean)
    dec = params["decoder"]
    parts = []
    if first:
        ctx = _Cache(None)
        parts.append(decoder_apply(dec, x[:, :, :1], ctx, cfg, first_chunk=True))
        caches = ctx.caches_out
        x = x[:, :, 1:]
    g = max(1, frames_per_step)
    for s in range(0, x.shape[2], g):
        ctx = _Cache(caches)
        parts.append(decoder_apply(dec, x[:, :, s : s + g], ctx, cfg, first_chunk=False))
        caches = ctx.caches_out
    frames = torch.clamp(torch.cat(parts, dim=2), -1.0, 1.0)
    if out_uint8:
        frames = torch.clamp(torch.round((frames.float() / 2.0 + 0.5) * 255.0), 0, 255).to(torch.uint8)
    return frames, caches


def _default_frames_per_step(lh, lw):
    return max(1, min(4, (4 * 48 * 48) // max(lh * lw, 1)))


def decode_video(params, z, cfg, frames_per_step: Optional[int] = None):
    """z [B, z, Tl, h, w] (normalised) -> video [B, 3, 1 + 4(Tl-1), H, W] in [-1, 1]."""
    if frames_per_step is None:
        frames_per_step = _default_frames_per_step(z.shape[3], z.shape[4])
    frames, _ = _decode_segment(params, z, None, cfg, frames_per_step, first=True)
    return frames


def decode_video_segmented(params, z, cfg, segment_latents: Optional[int] = None,
                           frames_per_step: Optional[int] = None, out_uint8: bool = False):
    """Segmented streaming decode: a list of [B, 3, Ts, H, W] segments (uint8
    display frames when `out_uint8`) with the conv caches carried across
    segments; their concatenation equals `decode_video`."""
    tl, lh, lw = z.shape[2], z.shape[3], z.shape[4]
    if frames_per_step is None:
        frames_per_step = _default_frames_per_step(lh, lw)
    if segment_latents is None:
        segment_latents = max(2 * frames_per_step, 4)
    outs, caches, s = [], None, 0
    while s < tl:
        n = min(segment_latents, tl - s)
        frames, caches = _decode_segment(params, z[:, :, s : s + n], caches, cfg,
                                         frames_per_step, first=(s == 0), out_uint8=out_uint8)
        outs.append(frames)
        s += n
    return outs
