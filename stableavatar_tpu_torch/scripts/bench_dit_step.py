"""The DiT window-step across the fast path's configurations
(counterpart of the JAX package's `scripts/bench_dit_step.py`).

One CFG-tripled window of the 1.3B DiT at 512x512 (21 latent frames of
64x64, 21,504 tokens), random bf16 weights from a seed, stepped --inner
times with each output fed back into the latents; one warm-up forward
first.  Configurations:

  base       bf16, K1 attention
  rope       split-pair rope (prepared params), K1
  rope_qk    + int8 Q.K^T self-attention (K2) and the fused K5 cross
  rope_qkpv  + int8 P.V too (K2v-qkpv) and K5
  w8a8       W8A8 linears without the rope permutation, K1
  full       rope + W8A8 + K2 + K5 (the --fast_path linears path)

On the card:

    python -m stableavatar_tpu_torch.scripts.bench_dit_step [configs...] [--inner 8]
"""

from __future__ import annotations

import argparse

import torch

from stableavatar_tpu_torch.config import WAN_1_3B, tiny_debug_configs
from stableavatar_tpu_torch.models.dit import dit_forward, init_dit
from stableavatar_tpu_torch.pipelines.common import resolve_device
from stableavatar_tpu_torch.scripts import elapsed_s
from stableavatar_tpu_torch.utils import fastpath

# name: (params: "plain" | "prepared" | "w8a8" | "prepared_quant", rope_split, attn_quant)
VARIANTS = {
    "base": ("plain", False, "none"),
    "rope": ("prepared", True, "none"),
    "rope_qk": ("prepared", True, "qk"),
    "rope_qkpv": ("prepared", True, "qkpv"),
    "w8a8": ("w8a8", False, "none"),
    "full": ("prepared_quant", True, "qk"),
}


def launches_per_forward(name: str, layers: int) -> dict:
    """The kernel launches of one forward of a configuration on the card
    (`ops/flash_attention.py` / `ops/cross_attention.py` launch counts):
    K1 for self-attention and both cross contexts, or an int8 self-attention
    kernel and K5."""
    quant = VARIANTS[name][2]
    if quant == "none":
        return {"flash_fwd_bf16": 3 * layers}
    return {f"flash_fwd_int8_{quant}": layers, "dual_context": layers}


def _w8a8_only(params, cfg):
    """W8A8 linears without the split-pair permutation (an identity one)."""
    ident = torch.arange(cfg.dim, device=params["blocks"][0]["self_attn"]["q"]["w"].device)
    out = dict(params)
    out["blocks"] = [fastpath._prepare_block(bp, ident, True) for bp in params["blocks"]]
    return out


def build_parser():
    ap = argparse.ArgumentParser("bench_dit_step")
    ap.add_argument("configs", nargs="*", default=["base", "full"], choices=list(VARIANTS))
    ap.add_argument("--inner", type=int, default=8, help="forwards timed per configuration")
    ap.add_argument("--frames", type=int, default=21, help="latent frames of the window")
    ap.add_argument("--size", type=int, default=512, help="video height and width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny debug DiT (CPU tests)")
    return ap


def main(argv=None) -> dict:
    """Returns {config: {"s_per_step", "forwards"}}: the seconds of one
    window-step and the number of forwards run (warm-up included)."""
    args = build_parser().parse_args(argv)
    configs = args.configs or ["base", "full"]
    device = resolve_device(args.device)
    cfg = tiny_debug_configs()[0] if args.tiny else WAN_1_3B
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_dit(gen, cfg, device, bf16)
    f, lh = args.frames, args.size // 8
    n_frames = (f - 1) * 4 + 1
    la = 2 * n_frames + 5  # wav2vec frames of the window's audio (167 at 81 frames)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf16)

    x = rand(3, cfg.out_dim, f, lh, lh)
    t = torch.full((3,), 500.0, device=device)
    text, clip = rand(3, cfg.text_len, cfg.text_dim), rand(3, cfg.clip_tokens, cfg.clip_dim)
    y = rand(3, cfg.in_dim - cfg.out_dim, f, lh, lh)
    vocal = rand(1, la, cfg.audio_in_dim)
    trees = {"plain": lambda: params,
             "prepared": lambda: fastpath.prepare_fast_params(params, cfg, quant=False),
             "w8a8": lambda: _w8a8_only(params, cfg),
             "prepared_quant": lambda: fastpath.prepare_fast_params(params, cfg, quant=True)}
    built = {}
    res = {}
    for name in configs:
        kind, rope_split, quant = VARIANTS[name]
        if kind not in built:
            built[kind] = trees[kind]()
        p = built[kind]

        def step(lat, p=p, rope_split=rope_split, quant=quant):
            out = dit_forward(p, cfg, lat, t, text, clip, y, vocal,
                              video_sample_n_frames=n_frames, vocal_cfg_tile=True,
                              rope_split=rope_split, attn_quant=quant)
            return (lat.float() - 0.01 * out.float()).to(lat.dtype)

        def chain():
            lat = x
            for _ in range(args.inner):
                lat = step(lat)
            return lat

        with torch.no_grad():
            step(x)  # warm-up
            _, s = elapsed_s(chain, device)
        res[name] = {"s_per_step": s / args.inner, "forwards": 1 + args.inner}
        print(f"{name:10s}: {s / args.inner:7.3f} s/step", flush=True)
    return res


if __name__ == "__main__":
    main()
