"""The 1.3B DiT's parts at the 512^2 window shape, each chained over its 30
layers (counterpart of the JAX package's `scripts/profile_step_parts.py`).

Times, with CUDA events, the hot parts of a window-step on [3, 21504, 1536]
bf16 activations and block 0's random weights:

  1. self-attention alone (`ops/attention.py:attention`, K1), reshapes included;
  2. the q / k / v / o projections with the q / k RMS norms and the rope;
  2b. the same without the rope;
  3. the FFN with its modulated LayerNorm;
  4. the cross-attention branch: text and image contexts (two K1 calls).

On the card:

    python -m stableavatar_tpu_torch.scripts.profile_step_parts
"""

from __future__ import annotations

import argparse

import torch

from stableavatar_tpu_torch.config import WAN_1_3B, tiny_debug_configs
from stableavatar_tpu_torch.models.dit import init_dit
from stableavatar_tpu_torch.models.vocal_projector import apply_linear
from stableavatar_tpu_torch.ops.activations import gelu_tanh
from stableavatar_tpu_torch.ops.attention import attention
from stableavatar_tpu_torch.ops.norms import layer_norm, rms_norm
from stableavatar_tpu_torch.ops.rope import rope_apply, rope_freqs_3d
from stableavatar_tpu_torch.pipelines.common import resolve_device
from stableavatar_tpu_torch.scripts import elapsed_s

# the parts, and the K1 launches of one layer of each on the card
PARTS = {"self_attn": 1, "proj_rope": 0, "proj": 0, "ffn": 0, "cross_attn": 2}


def build_parser():
    ap = argparse.ArgumentParser("profile_step_parts")
    ap.add_argument("--layers", type=int, default=None, help="chain length (the DiT's depth)")
    ap.add_argument("--grid", type=int, nargs=3, default=(21, 32, 32),
                    help="latent frames and token rows / columns of the window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny debug DiT (CPU tests)")
    return ap


def main(argv=None) -> dict:
    """Returns {part: {"ms_per_layer", "calls"}}, calls counting each
    layer of the warm-up run and of the timed run."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_debug_configs()[0] if args.tiny else WAN_1_3B
    layers = args.layers or cfg.num_layers
    n, d, dim = cfg.num_heads, cfg.head_dim, cfg.dim
    b, l = 3, args.grid[0] * args.grid[1] * args.grid[2]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    bp = init_dit(gen, cfg, device, bf16)["blocks"][0]
    x = torch.randn((b, l, dim), generator=gen, device=device).to(bf16)
    freqs = rope_freqs_3d(tuple(args.grid), d, device=device)
    sa, ffn, ca = bp["self_attn"], bp["ffn"], bp["cross_attn"]
    e = torch.randn((b, 1, dim), generator=gen, device=device).to(bf16)
    ctx_t = torch.randn((b, cfg.text_len, dim), generator=gen, device=device).to(bf16)
    ctx_i = torch.randn((b, cfg.clip_tokens, dim), generator=gen, device=device).to(bf16)
    eps = cfg.eps

    def heads(t):
        return t.reshape(b, -1, n, d)

    def self_attn(h):
        q = heads(h)
        return attention(q, q, q).reshape(b, l, dim)

    def proj(h, rope=True):
        q = heads(rms_norm(apply_linear(sa["q"], h), sa["norm_q"]["w"], eps))
        k = heads(rms_norm(apply_linear(sa["k"], h), sa["norm_k"]["w"], eps))
        v = heads(apply_linear(sa["v"], h))
        if rope:
            q, k = rope_apply(q, freqs).to(h.dtype), rope_apply(k, freqs).to(h.dtype)
        return apply_linear(sa["o"], (q + k + v).reshape(b, l, dim))

    def feed_forward(h):
        temp = (layer_norm(h, eps=1e-6) * (1 + e) + e).to(h.dtype)
        return h + apply_linear(ffn["fc2"], gelu_tanh(apply_linear(ffn["fc1"], temp))) * e

    def cross_attn(h):
        q = heads(rms_norm(apply_linear(ca["q"], h), ca["norm_q"]["w"], eps).to(h.dtype))
        k = heads(rms_norm(apply_linear(ca["k"], ctx_t), ca["norm_k"]["w"], eps).to(h.dtype))
        v = heads(apply_linear(ca["v"], ctx_t))
        ki = heads(rms_norm(apply_linear(ca["k_img"], ctx_i), ca["norm_k_img"]["w"], eps
                            ).to(h.dtype))
        vi = heads(apply_linear(ca["v_img"], ctx_i))
        out = attention(q, k, v) + attention(q, ki, vi)
        return apply_linear(ca["o"], out.reshape(b, l, dim))

    fns = {"self_attn": self_attn, "proj_rope": proj, "proj": lambda h: proj(h, rope=False),
           "ffn": feed_forward, "cross_attn": cross_attn}
    labels = {"self_attn": "self-attn flash (incl reshape)",
              "proj_rope": "qkvo proj + norms + rope", "proj": "qkvo proj + norms (no rope)",
              "ffn": "FFN (+modulated LN epilogue)", "cross_attn": "cross-attn (text+img)"}
    res = {}
    for name, fn in fns.items():
        def chain(fn=fn):
            h = x
            for _ in range(layers):
                h = fn(h)
            return h

        with torch.no_grad():
            chain()  # warm-up
            _, s = elapsed_s(chain, device)
        res[name] = {"ms_per_layer": s / layers * 1e3, "calls": 2 * layers}
        print(f"{labels[name]:30s}: {s / layers * 1e3:8.2f} ms/layer  -> {s:6.3f} s/step",
              flush=True)
    return res


if __name__ == "__main__":
    main()
