"""Layers shared by the reference models, all in float32."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

# logits of one attention block stay under this many bytes
ATTN_BLOCK_BYTES = 2 << 30


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32 (cuBLAS and cuDNN), restored on exit, so
    that the program's own settings are left as they were."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(p, x):
    """x W^T + b with the weight in [d_out, d_in] layout, in float32."""
    b = p.get("b")
    return F.linear(x.float(), p["w"].float(), None if b is None else b.float())


def layer_norm(x, p=None, eps=1e-6):
    w = None if p is None else p["w"].float()
    b = None if p is None else p["b"].float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps)


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    return F.gelu(x)


def attention(q, k, v, k_lens=None, scale=None):
    """Softmax attention of q [B, Lq, N, D] over k, v [B, Lk, N, D]; keys at or
    past k_lens[b] are left out (a row with none attends nothing: zeros)."""
    b, lq, n, d = q.shape
    lk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kt = k.float().permute(0, 2, 3, 1)  # [B, N, D, Lk]
    vt = v.float().permute(0, 2, 1, 3)  # [B, N, Lk, D]
    mask = None
    if k_lens is not None:
        cols = torch.arange(lk, device=q.device)
        mask = (cols[None, :] < k_lens.to(q.device)[:, None])[:, None, None, :]
    block = max(1, min(lq, ATTN_BLOCK_BYTES // (4 * b * n * lk)))
    out = torch.empty((b, lq, n, d), dtype=torch.float32, device=q.device)
    for s in range(0, lq, block):
        qb = q[:, s:s + block].float().permute(0, 2, 1, 3)
        logits = torch.matmul(qb, kt) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        if mask is not None:
            probs = torch.nan_to_num(probs, nan=0.0)
        out[:, s:s + block] = torch.matmul(probs, vt).permute(0, 2, 1, 3)
    return out


def sinusoidal_embedding(dim, position):
    half = dim // 2
    freqs = torch.as_tensor(np.exp(-np.log(10000.0) * np.arange(half) / half),
                            dtype=torch.float32, device=position.device)
    arg = position.float()[..., None] * freqs
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def rope_tables(grid, head_dim, device):
    """cos, sin [F*H*W, head_dim/2] of Wan's 3-D rope: the half head dim split
    (c - 2(c//3), c//3, c//3) over frames, height and width, theta 1e4."""
    f, h, w = grid
    c = head_dim // 2
    parts = (c - 2 * (c // 3), c // 3, c // 3)

    def axis(n, half):
        inv = 1.0 / np.power(10000.0, np.arange(0, 2 * half, 2, dtype=np.float64) / (2 * half))
        return np.outer(np.arange(n, dtype=np.float64), inv)

    af, ah, aw = axis(f, parts[0]), axis(h, parts[1]), axis(w, parts[2])
    ang = np.concatenate([
        np.broadcast_to(af[:, None, None], (f, h, w, parts[0])),
        np.broadcast_to(ah[None, :, None], (f, h, w, parts[1])),
        np.broadcast_to(aw[None, None, :], (f, h, w, parts[2])),
    ], axis=-1).reshape(f * h * w, c)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def rope(x, cos, sin):
    """Rotate the interleaved pairs (2j, 2j+1) of x [B, L, N, D]."""
    b, l, n, d = x.shape
    xf = x.float().reshape(b, l, n, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(b, l, n, d)


def flow_match_sigmas(steps: int, shift: float, train_steps: int = 1000) -> np.ndarray:
    """The flow-match Euler schedule (diffusers' FlowMatchEulerDiscreteScheduler
    without dynamic shifting): `steps` + 1 float32 sigmas, 0 last."""
    def shifted(s):
        return shift * s / (1 + (shift - 1) * s)

    train = shifted(np.linspace(1, train_steps, train_steps, dtype=np.float32)[::-1] / train_steps)
    ts = np.linspace(float(train[0]) * train_steps, float(train[-1]) * train_steps, steps,
                     dtype=np.float32)
    sig = shifted(ts / train_steps)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def window_plan(infer_length: int, frames: int, overlap: int):
    """[(start, end)) latent windows; the last shifted back to full size."""
    if frames >= infer_length:
        return [(0, infer_length)]
    out, s = [], 0
    while s + frames < infer_length:
        out.append((s, s + frames))
        s += frames - overlap
    out.append((infer_length - frames, infer_length))
    return out


def audio_slices(windows, infer_length, samples_per_frame, total):
    """Raw sample indices of each window: 4 video frames a latent frame, taken
    modulo the track; the last window is cut at the track's end."""
    out = []
    for s, e in windows:
        start = s * 4 * samples_per_frame
        stop = max(total, start + 1) if e == infer_length else start + (e - s) * 4 * samples_per_frame
        out.append(np.mod(np.arange(start, stop), total))
    return out


def ramp(n: int) -> np.ndarray:
    """Uniform cross-fade weights 0 -> 1 of the new window over the overlap."""
    return np.arange(n, dtype=np.float32) / max(n - 1, 1)


def ulp_bf16(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)

