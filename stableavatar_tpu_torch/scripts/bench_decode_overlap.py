"""The VAE decode and its copy to the host, with and without the overlap
(counterpart of the JAX package's `scripts/bench_decode_overlap.py`).

At the pipeline's geometry (512x512, 27 latents -> 105 frames), random
bf16 VAE weights from a seed:

  A) monolithic: every uint8 segment of the streaming decode on the card
     (`models/vae.py:_decode_segments`), then one copy of the whole video
     to the host after the last segment's decode;
  B) overlapped: `decode_video_segments(out_uint8=True)`, each segment
     copied into pinned memory behind its decode and handed to the host
     while the card decodes the next.

Both return the same frames, bit for bit (the same segments).  Each is
timed with CUDA events on the card, the best of --reps runs.  On the card:

    python -m stableavatar_tpu_torch.scripts.bench_decode_overlap [--latents 27] [--size 512]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stableavatar_tpu_torch.config import VAEConfig
from stableavatar_tpu_torch.models.vae import _decode_segments, decode_video_segments, init_vae
from stableavatar_tpu_torch.pipelines.common import resolve_device
from stableavatar_tpu_torch.scripts import elapsed_s


def build_parser():
    ap = argparse.ArgumentParser("bench_decode_overlap")
    ap.add_argument("--latents", type=int, default=27)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny debug VAE (CPU tests)")
    return ap


def main(argv=None) -> dict:
    """Returns {"frames", "monolithic_s", "overlapped_s", "equal"}: the
    seconds of each run of A and B and whether their frames are equal."""
    from stableavatar_tpu_torch.config import tiny_debug_configs

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_debug_configs()[1] if args.tiny else VAEConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_vae(gen, cfg, device, torch.bfloat16)
    lh = lw = args.size // cfg.spatial_compression_ratio
    z = torch.randn((1, cfg.z_dim, args.latents, lh, lw), generator=gen, device=device
                    ).to(torch.bfloat16)
    n_frames = 1 + cfg.temporal_compression_ratio * (args.latents - 1)
    print(f"{args.latents} latents -> {n_frames} frames at {args.size}^2 "
          f"({n_frames * args.size * args.size * 3 / 1e6:.0f} MB uint8) on {device}")

    def monolithic():
        segs = list(_decode_segments(params, z, cfg, out_uint8=True))
        return torch.cat(segs, dim=2).cpu().numpy()

    def overlapped():
        return torch.cat(list(decode_video_segments(params, z, cfg, out_uint8=True)),
                         dim=2).numpy()

    res = {"frames": n_frames, "monolithic_s": [], "overlapped_s": []}
    outs = {}
    for _ in range(args.reps + 1):  # the first round warms up
        for name, fn in (("monolithic", monolithic), ("overlapped", overlapped)):
            outs[name], s = elapsed_s(fn, device)
            res[f"{name}_s"].append(s)
    for name in ("monolithic", "overlapped"):
        runs = res[f"{name}_s"] = res[f"{name}_s"][1:]
        best = min(runs)
        print(f"{name:11s} decode + copy to the host: {best:7.3f} s "
              f"({n_frames / best:6.2f} frames/s) all={[round(s, 3) for s in runs]}")
    res["equal"] = bool(np.array_equal(outs["monolithic"], outs["overlapped"]))
    print(f"frames equal bit for bit: {res['equal']} ({outs['overlapped'].shape})")
    return res


if __name__ == "__main__":
    main()
