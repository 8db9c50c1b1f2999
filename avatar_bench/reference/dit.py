"""The Wan2.1 DiT with StableAvatar's audio branch, in float32.

It follows the published block (Wan2.1 `WanAttentionBlock`, i2v cross
attention to text and CLIP image tokens) with StableAvatar's additions: a
timestep-aware vocal projector whose audio queries attend to the latent
tokens of their own frame, and a per-latent-frame vocal cross-attention in
every block.  `cfg` is the configuration file's "dit" object.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from avatar_bench.reference.common import (
    attention,
    gelu_exact,
    gelu_tanh,
    layer_norm,
    linear,
    rms_norm,
    rope,
    rope_tables,
    sinusoidal_embedding,
)


def patchify(x, patch):
    b, c, f, h, w = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x, grid, patch, out_dim):
    b = x.shape[0]
    f, h, w = grid
    pt, ph, pw = patch
    x = x.reshape(b, f, h, w, pt, ph, pw, out_dim).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


def vocal_windows(audio_len: int, num_frames: int, expand: int = 4):
    """Per latent frame, the audio tokens around it (StableAvatar's
    `split_audio_sequence` widened by `expand` a side): gather indices
    [F, Lw], validity mask [F, Lw] and valid counts [F]."""
    per = audio_len / num_frames
    half = int(per * 4 / 2)
    centres = [0] + [int((per * ((i - 1) * 4 + 1) + per * (i * 4 + 1)) / 2) - 1
                     for i in range(1, (num_frames - 1) // 4 + 1)]
    ranges = [[c - half, c + half] for c in centres]
    if len(ranges) > 1:
        ranges[0] = [-(half * 2 - ranges[1][0]), ranges[1][0]]
    ranges = [[s - expand, e + expand] for s, e in ranges]
    lw = max(e - s + 1 for s, e in ranges)
    gather = np.zeros((len(ranges), lw), dtype=np.int64)
    mask = np.zeros((len(ranges), lw), dtype=np.float32)
    lens = np.zeros(len(ranges), dtype=np.int64)
    for i, (s, e) in enumerate(ranges):
        lo, hi = max(s, 0), min(e, audio_len - 1)
        n = max(hi - lo + 1, 0)
        lens[i] = n
        gather[i] = np.clip(lo + np.arange(lw), 0, audio_len - 1)
        mask[i, :n] = 1.0
    return gather, mask, lens


def vocal_projector(p, cfg, audio, latents, e0, e, n_frames):
    """audio [B, La, 768] -> (vocal context [B, F, Lw, dim], valid counts [F])."""
    pp = p["proj"]
    if "fc" in pp:
        x = linear(pp["fc"], audio)
    else:
        x = linear(pp["fc2"], layer_norm(linear(pp["fc1"], audio), pp["norm1"], 1e-5))
    x = layer_norm(x, pp["norm"], 1e-5)
    gather, mask, lens = vocal_windows(x.shape[1], n_frames)
    b, vd = x.shape[0], x.shape[-1]
    f, lw = gather.shape
    idx = torch.as_tensor(gather.reshape(-1), device=x.device)
    x = x.index_select(1, idx).reshape(b, f, lw, vd)
    x = (x * torch.as_tensor(mask, device=x.device)[None, :, :, None]).reshape(b, f * lw, vd)
    heads, eps = cfg["vocal_num_heads"], cfg["eps"]
    for bp in p["blocks"]:
        m = bp["modulation"].float() + e0
        x = x + (layer_norm(x, None, eps) * (1 + m[:, 1:2]) + m[:, 0:1]) * m[:, 2:3]
        normed = layer_norm(x, bp["norm3"], eps)
        ca = bp["cross_attn"]
        d = vd // heads
        q = rms_norm(linear(ca["q"], normed), ca["norm_q"]["w"], eps).reshape(b * f, -1, heads, d)
        k = rms_norm(linear(ca["k"], latents), ca["norm_k"]["w"], eps).reshape(b * f, -1, heads, d)
        v = linear(ca["v"], latents).reshape(b * f, -1, heads, d)
        x = x + linear(ca["o"], attention(q, k, v).reshape(b, -1, vd))
        h = layer_norm(x, None, eps) * (1 + m[:, 4:5]) + m[:, 3:4]
        x = x + linear(bp["ffn"]["fc2"], gelu_tanh(linear(bp["ffn"]["fc1"], h))) * m[:, 5:6]
    hm = p["final_head"]["modulation"].float() + e[:, None]
    x = linear(p["final_head"]["final_proj"], layer_norm(x, None, cfg["eps"]) * (1 + hm[:, 1:2])
               + hm[:, 0:1])
    return x.reshape(b, f, lw, vd), torch.as_tensor(lens, device=x.device)


def self_attention(p, cfg, h, cos, sin):
    """The self-attention branch on its modulated input h [B, L, dim]."""
    b, l, dim = h.shape
    heads, eps = cfg["num_heads"], cfg["eps"]
    d = dim // heads
    q = rope(rms_norm(linear(p["q"], h), p["norm_q"]["w"], eps).reshape(b, l, heads, d), cos, sin)
    k = rope(rms_norm(linear(p["k"], h), p["norm_k"]["w"], eps).reshape(b, l, heads, d), cos, sin)
    v = linear(p["v"], h).reshape(b, l, heads, d)
    return linear(p["o"], attention(q, k, v).reshape(b, l, dim))


def cross_attention(p, cfg, h, text, img, vocal, vocal_lens, n_latent_frames):
    """Text + image + per-latent-frame vocal cross-attention on the normed
    tokens h [B, L, dim]; vocal [B, F, Lw, dim], vocal_lens [F]."""
    b, l, dim = h.shape
    heads, eps = cfg["num_heads"], cfg["eps"]
    d = dim // heads
    q = rms_norm(linear(p["q"], h), p["norm_q"]["w"], eps).reshape(b, l, heads, d)
    kt = rms_norm(linear(p["k"], text), p["norm_k"]["w"], eps).reshape(b, -1, heads, d)
    vt = linear(p["v"], text).reshape(b, -1, heads, d)
    ki = rms_norm(linear(p["k_img"], img), p["norm_k_img"]["w"], eps).reshape(b, -1, heads, d)
    vi = linear(p["v_img"], img).reshape(b, -1, heads, d)
    out = attention(q, kt, vt) + attention(q, ki, vi)
    f = n_latent_frames
    vq = q.reshape(b * f, l // f, heads, d)
    vk = linear(p["k_vocal"], vocal).reshape(b * f, -1, heads, d)
    vv = linear(p["v_vocal"], vocal).reshape(b * f, -1, heads, d)
    out = out + attention(vq, vk, vv, k_lens=vocal_lens.repeat(b)).reshape(b, l, heads, d)
    return linear(p["o"], out.reshape(b, l, dim))


def ffn(p, h):
    return linear(p["fc2"], gelu_tanh(linear(p["fc1"], h)))


def block(p, cfg, x, e0, text, img, vocal, vocal_lens, cos, sin, n_latent_frames):
    eps = cfg["eps"]
    m = p["modulation"].float() + e0
    h = layer_norm(x, None, eps) * (1 + m[:, 1:2]) + m[:, 0:1]
    x = x + self_attention(p["self_attn"], cfg, h, cos, sin) * m[:, 2:3]
    h = layer_norm(x, p["norm3"], eps)
    x = x + cross_attention(p["cross_attn"], cfg, h, text, img, vocal, vocal_lens, n_latent_frames)
    h = layer_norm(x, None, eps) * (1 + m[:, 4:5]) + m[:, 3:4]
    return x + ffn(p["ffn"], h) * m[:, 5:6]


def dit_forward(params, cfg, x, t, text, clip_fea, y, audio, n_frames: int, rows=(0, 1, 2)):
    """The velocity [B, out_dim, F, H, W] of rows `rows` of a CFG batch:
    x [B, 16, F, H, W] latents, t [B] timesteps, text [B, 512, 4096],
    clip_fea [B, 257, 1280], y [B, 20, F, H, W] (first-frame mask and
    reference latents), audio [1, La, 768] wav2vec states of the window,
    n_frames video frames.  The CFG rows are [uncond, drop-audio, cond]: the
    audio reaches the last two only, projected on the latents of the last
    (every row has the same latents)."""
    rows = list(rows)
    x, t, text, clip_fea, y = (z[rows] for z in (x, t, text, clip_fea, y))
    patch = tuple(cfg["patch_size"])
    b, _, f, h, w = x.shape
    grid = (f // patch[0], h // patch[1], w // patch[2])
    dim, heads = cfg["dim"], cfg["num_heads"]
    tokens = linear(params["patch_embedding"], patchify(torch.cat([x, y], 1).float(), patch))
    cos, sin = rope_tables(grid, dim // heads, x.device)

    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], sinusoidal_embedding(cfg["freq_dim"], t))))
    e0 = linear(params["time_projection"]["fc"], F.silu(e)).reshape(b, 6, dim)
    tp = params["text_embedding"]
    text = linear(tp["fc2"], gelu_tanh(linear(tp["fc1"], text)))
    ip = params["img_emb"]
    img = layer_norm(linear(ip["fc2"], gelu_exact(linear(ip["fc1"], layer_norm(clip_fea, ip["norm1"], 1e-5)))),
                     ip["norm2"], 1e-5)

    vc, lens = vocal_projector(params["vocal_projector"], cfg, audio[-1:].float(), tokens[-1:],
                               e0[-1:], e[-1:], n_frames)
    vocal = torch.cat([torch.zeros_like(vc), vc, vc], 0)[rows]
    n_latent = (n_frames - 1) // 4 + 1
    for bp in params["blocks"]:
        tokens = block(bp, cfg, tokens, e0, text, img, vocal, lens, cos, sin, n_latent)

    hp = params["head"]
    hm = hp["modulation"].float() + e[:, None]
    out = linear(hp["head"], layer_norm(tokens, None, cfg["eps"]) * (1 + hm[:, 1:2]) + hm[:, 0:1])
    return unpatchify(out, grid, patch, cfg["out_dim"])


def guidance(pred, text_scale: float, audio_scale: float):
    """Dual CFG over [uncond, drop-audio, cond]."""
    u, a, c = pred.float().chunk(3, dim=0)
    return u + audio_scale * (a - u) + text_scale * (c - a)
