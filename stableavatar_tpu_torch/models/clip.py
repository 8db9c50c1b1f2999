"""CLIP ViT-H/14 visual tower, port of `stableavatar_tpu/models/clip.py`.

Pre-norm ViT with exact GELU; features are taken after all but the last
block (`use_31_block`) and returned un-normalised, [B, 257, 1280].
`preprocess_reference_image` reproduces `jax.image.resize(method="cubic")`
exactly: the same Keys cubic kernel (a = -0.5), widened by the downscale
factor (antialiasing), applied as one separable weight matrix per axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from stableavatar_tpu_torch.models.vocal_projector import _affine, _linear, _normal, apply_linear
from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.norms import layer_norm


def init_clip_visual(gen, cfg, device=None, dtype=torch.float32):
    d = cfg.vision_dim
    kw = dict(device=device, dtype=dtype)

    def block():
        return {
            "norm1": _affine(d, device, dtype),
            "attn": {"qkv": _linear(gen, d, d * 3, **kw), "proj": _linear(gen, d, d, **kw)},
            "norm2": _affine(d, device, dtype),
            "mlp": {"fc1": _linear(gen, d, d * cfg.mlp_ratio, **kw),
                    "fc2": _linear(gen, d * cfg.mlp_ratio, d, **kw)},
        }

    patch_in = 3 * cfg.patch_size * cfg.patch_size
    return {
        "patch_embedding": {"w": _normal(gen, (d, patch_in), 0.02, device, dtype)},
        "cls_embedding": _normal(gen, (1, 1, d), d ** -0.5, device, dtype),
        "pos_embedding": _normal(gen, (1, cfg.num_tokens, d), d ** -0.5, device, dtype),
        "pre_norm": _affine(d, device, dtype),
        "blocks": [block() for _ in range(cfg.vision_layers)],
    }


def _vit_block(p, x, num_heads, eps):
    b, l, d = x.shape
    hd = d // num_heads
    h = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps)
    qkv = apply_linear(p["attn"]["qkv"], h).reshape(b, l, 3, num_heads, hd)
    o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, l, d)
    x = x + apply_linear(p["attn"]["proj"], o)
    h = layer_norm(x, p["norm2"]["w"], p["norm2"]["b"], eps)
    return x + apply_linear(p["mlp"]["fc2"], F.gelu(apply_linear(p["mlp"]["fc1"], h)))


def clip_visual_forward(params, cfg, images: torch.Tensor, use_31_block: bool = True):
    """images [B, 3, S, S] (S = cfg.image_size, CLIP-normalised) -> [B, 257, dim]."""
    b = images.shape[0]
    p = cfg.patch_size
    g = cfg.image_size // p
    x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, cfg.num_patches, -1)
    x = apply_linear(params["patch_embedding"], x)
    cls = params["cls_embedding"].to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"].to(x.dtype)
    x = layer_norm(x, params["pre_norm"]["w"], params["pre_norm"]["b"], cfg.eps)
    blocks = params["blocks"][:-1] if use_31_block else params["blocks"]
    for bp in blocks:
        x = _vit_block(bp, x, cfg.vision_heads, cfg.eps)
    return x


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of jax.image.resize's cubic scale_and_translate
    (antialias=True, zero translation), computed in fp32 like jax."""
    inv_scale = np.float32(1.0) / (np.float32(out_size) / np.float32(in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32).T


def preprocess_reference_image(image: torch.Tensor, cfg) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> [B, 3, S, S] cubic-resized to the CLIP
    input size, rescaled to [0, 1] and CLIP-normalised."""
    h, w = image.shape[-2:]
    s = cfg.image_size
    wh = torch.as_tensor(_resize_weights(h, s), device=image.device)
    ww = torch.as_tensor(_resize_weights(w, s), device=image.device)
    x = torch.einsum("oh,bchw,pw->bcop", wh, image.float(), ww)
    x = x * 0.5 + 0.5
    mean = torch.as_tensor(cfg.image_mean, device=image.device)[None, :, None, None]
    std = torch.as_tensor(cfg.image_std, device=image.device)[None, :, None, None]
    return (x - mean) / std
