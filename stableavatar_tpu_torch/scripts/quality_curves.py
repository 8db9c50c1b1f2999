"""Quality against steps, and the TeaCache frontier, at the pipeline's
geometry (counterpart of the JAX package's `scripts/quality_curves.py`).

Runs the port's `generate_long` denoise loop at 512x512 over 2 sliding
windows (overlap 15) on structured inputs (a smooth radial reference
image, a harmonic voice-like waveform) and reports, against the Euler
reference trajectory of --full_steps steps (same seed):

1. PSNR of UniPC at the steps of --steps, and of Euler at --euler_steps;
2. the TeaCache frontier: the skipped share, the wall speedup and the PSNR
   at each threshold of --thresholds.

Metrics: `psnr_latent` over the final latents (peak = the reference
latents' range) and `psnr_video_f32` over the unclipped fp32 VAE decode of
bf16 latents (peak = its range); uint8 display frames would quantise
random-weight differences away.  Wall times cover the denoise sweep (the
decode is left out), CUDA events on the card.  With random weights (the
default) the DiT is made solver-sensitive first (`sensitize_random_init`);
--ckpt_root loads checkpoints through the inference CLI's `load_models`.

--small runs the smallest step lists (UniPC 2 and 3, Euler 2, full 3, one
threshold); --layers cuts the DiT's depth.  --out writes the results as
JSON after every row.  On the card:

    python -m stableavatar_tpu_torch.scripts.quality_curves [--small] [--out curves.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from stableavatar_tpu_torch.models.teacache import TeaCache, get_teacache_coefficients
from stableavatar_tpu_torch.models.vae import decode_video
from stableavatar_tpu_torch.pipelines.common import WanModels, resolve_device
from stableavatar_tpu_torch.pipelines.long import generate_long
from stableavatar_tpu_torch.scripts import elapsed_s


def structured_inputs(size, n_windows, overlap=15, fps=25, sr=16000, clip_frames=81):
    """Smooth, deterministic inputs: a radial-gradient reference image
    [1, 3, H, W] in [-1, 1] and a harmonic voice-like waveform long enough
    for `n_windows` windows of `clip_frames` frames."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.45) ** 2)
    img = np.stack([
        0.8 - r * 1.2,
        0.6 - r * 0.9 + 0.2 * np.sin(6.28 * xx),
        0.5 - r * 1.0 + 0.2 * np.cos(6.28 * yy),
    ])
    ref_image = np.clip(img, -1, 1)[None]
    latent_window = (clip_frames - 1) // 4 + 1
    infer_length = latent_window + (latent_window - overlap) * (n_windows - 1)
    total_video_frames = (infer_length - 1) * 4 + 1
    t = np.arange(total_video_frames * (sr // fps)) / sr
    wav = (
        0.35 * np.sin(2 * np.pi * 155 * t)
        + 0.2 * np.sin(2 * np.pi * 310 * t + 0.5)
        + 0.1 * np.sin(2 * np.pi * 620 * t + 1.1)
    ) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))  # syllable-rate envelope
    return ref_image.astype(np.float32), wav.astype(np.float32)


def sensitize_random_init(models: WanModels, seed: int = 1234) -> None:
    """Make a random DiT solver-discriminating, in place: its output head
    is zero-initialised (so every solver and step count gives the same
    latents) and its time MLP barely varies with t.  The head is drawn at
    1/sqrt(dim) and the time MLP scaled by 5, so the velocity varies with
    (x, t) as a trained model's does; this measures solver agreement, not
    perceptual quality."""
    d = models.dit_cfg.dim
    head = models.dit_params["head"]["head"]
    gen = torch.Generator(device=head["w"].device).manual_seed(seed)
    head["w"] = (torch.randn(head["w"].shape, generator=gen, device=head["w"].device)
                 / d ** 0.5).to(head["w"].dtype)
    te = models.dit_params["time_embedding"]
    for fc in ("fc1", "fc2"):
        te[fc]["w"] = te[fc]["w"] * 5.0


def build_models(device, tiny: bool = False, layers=None) -> WanModels:
    """Random seeded weights on the fast path (split-pair rope, W8A8, K2,
    K5): WAN_1_3B (depth `layers` if given) with the VAE, CLIP and wav2vec,
    or the tiny debug configs."""
    from stableavatar_tpu_torch import config
    from stableavatar_tpu_torch.models.clip import init_clip_visual
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.models.vae import init_vae
    from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2
    from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

    dit_cfg, vae_cfg, _, clip_cfg, w2v_cfg = config.tiny_debug_configs() if tiny else (
        config.WAN_1_3B, config.VAEConfig(), None, config.CLIPConfig(), config.Wav2Vec2Config())
    if layers:
        dit_cfg = dataclasses.replace(dit_cfg, num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    dit = prepare_fast_params(init_dit(gen, dit_cfg, device, bf16), dit_cfg, quant=True)
    return WanModels(
        dit_params=dit, dit_cfg=dit_cfg, vae_params=init_vae(gen, vae_cfg, device, bf16),
        vae_cfg=vae_cfg, clip_params=init_clip_visual(gen, clip_cfg, device, bf16),
        clip_cfg=clip_cfg, wav2vec_params=init_wav2vec2(gen, w2v_cfg, device, torch.float32),
        wav2vec_cfg=w2v_cfg, rope_split=True, attn_quant="qk", device=device)


def psnr_from_mse(mse: float, peak: float) -> float:
    if mse <= 0:
        return float("inf")
    return 10.0 * float(np.log10(peak * peak / mse))


def build_parser():
    ap = argparse.ArgumentParser("quality_curves")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--clip_frames", type=int, default=81)
    ap.add_argument("--overlap", type=int, default=15, help="overlap of the latent windows")
    ap.add_argument("--steps", type=int, nargs="+", default=[15, 20, 25, 35, 50],
                    help="UniPC step counts")
    ap.add_argument("--euler_steps", type=int, nargs="+", default=[15, 25, 35])
    ap.add_argument("--thresholds", type=float, nargs="*", default=[0.05, 0.1, 0.2, 0.3])
    ap.add_argument("--full_steps", type=int, default=50, help="the Euler reference's steps")
    ap.add_argument("--small", action="store_true",
                    help="the smallest step lists: UniPC 2 3, Euler 2, full 3, threshold 0.05")
    ap.add_argument("--layers", type=int, default=None, help="cut the DiT to this depth")
    ap.add_argument("--ckpt_root", default=None,
                    help="checkpoints for the inference CLI's load_models (random otherwise)")
    ap.add_argument("--out", default=None, help="JSON file written after every row")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny debug models (CPU tests)")
    return ap


def main(argv=None) -> dict:
    """Returns the results: the reference's wall and peaks, the rows of
    `solver_curve` and `teacache_frontier`, and `dit_forwards`, the DiT
    forwards run (window calls that TeaCache did not skip)."""
    args = build_parser().parse_args(argv)
    if args.small:
        args.steps, args.euler_steps, args.thresholds, args.full_steps = [2, 3], [2], [0.05], 3
    device = resolve_device(args.device)
    prompt = ""
    if args.ckpt_root:
        from stableavatar_tpu_torch.cli.inference import build_parser as cli_parser
        from stableavatar_tpu_torch.cli.inference import load_models

        cli_args = cli_parser().parse_args(["--pretrained_model_name_or_path", args.ckpt_root,
                                            "--fast_path", "linears"])
        models = load_models(cli_args, device, keep_t5=True)
        prompt = "A person is talking with natural expressions"
    else:
        models = build_models(device, args.tiny, args.layers)
        sensitize_random_init(models)
    ref_image, wav = structured_inputs(args.size, args.windows, args.overlap,
                                       clip_frames=args.clip_frames)
    text_ctx = None
    if not args.ckpt_root:
        rng = np.random.default_rng(7)
        text_ctx = torch.as_tensor(
            rng.standard_normal((3, models.dit_cfg.text_len, models.dit_cfg.text_dim)) * 0.3,
            dtype=torch.bfloat16, device=device)
    n_windows = args.windows
    forwards = [0]

    def run(steps, scheduler="euler", teacache=None):
        """The denoise sweep alone: (final fp32 latents, wall seconds)."""
        m = dataclasses.replace(models, teacache=teacache)
        out, wall = elapsed_s(lambda: generate_long(
            m, ref_image=ref_image, vocal_waveform=wav, text_ctx=text_ctx, prompt=prompt,
            num_inference_steps=steps, clip_length=args.clip_frames,
            overlap_window_length=args.overlap, seed=42, scheduler=scheduler,
            output_type="latent"), device)
        forwards[0] += steps * n_windows - (teacache.skipped_calls if teacache else 0)
        return out.latents, wall

    def decode_f32(latents):
        with torch.no_grad():
            return decode_video(models.vae_params, latents.to(torch.bfloat16),
                                models.vae_cfg).float()

    def mse(a, b):
        return float(((a.float() - b.float()) ** 2).mean())

    results = {
        "full_steps": args.full_steps, "ref_solver": "euler",
        "geometry": (f"{args.size}x{args.size}, {n_windows} windows, overlap {args.overlap}; "
                     "wall = denoise sweep only (decode excluded)"),
        "weights": (f"checkpoints: {args.ckpt_root}" if args.ckpt_root else
                    "random seeded weights + solver sensitization (random head, 5x time MLP)"),
        "layers": models.dit_cfg.num_layers, "solver_curve": [], "teacache_frontier": [],
    }

    def flush():
        results["dit_forwards"] = forwards[0]
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    print(f"reference euler-{args.full_steps} trajectory ...", flush=True)
    ref_lat, ref_wall = run(args.full_steps)
    # a second run: the wall without first-call costs, and the repeat floor
    ref_lat2, ref_wall2 = run(args.full_steps)
    repeat = mse(ref_lat, ref_lat2)
    ref_wall = min(ref_wall, ref_wall2)
    ref_dec = decode_f32(ref_lat)
    lat_peak = float(ref_lat.max() - ref_lat.min())
    vid_peak = float(ref_dec.max() - ref_dec.min())
    nf = psnr_from_mse(repeat, lat_peak)
    results.update(euler_full_wall_s=ref_wall, latent_peak=lat_peak, video_f32_peak=vid_peak,
                   repeat_noise_floor_psnr_latent=None if np.isinf(nf) else nf)
    flush()

    def measure(latents, wall, **label):
        row = dict(label, psnr_latent=psnr_from_mse(mse(latents, ref_lat), lat_peak),
                   psnr_video_f32=psnr_from_mse(mse(decode_f32(latents), ref_dec), vid_peak),
                   wall_s=wall, speedup_vs_full=ref_wall / wall)
        print(row, flush=True)
        return row

    for solver, grid in (("unipc", args.steps), ("euler", args.euler_steps)):
        for steps in grid:
            lat, wall = run(steps, solver)
            results["solver_curve"].append(measure(lat, wall, solver=solver, steps=steps))
            flush()

    coef = get_teacache_coefficients("wan2.1-t2v-1.3b")
    for thr in args.thresholds:
        tc = TeaCache(coef, args.full_steps, rel_l1_thresh=thr, num_skip_start_steps=5)
        lat, wall = run(args.full_steps, "euler", teacache=tc)
        results["teacache_frontier"].append(measure(
            lat, wall, rel_l1_thresh=thr,
            skip_frac=tc.skipped_calls / max(tc.total_calls, 1)))
        flush()
    flush()
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
