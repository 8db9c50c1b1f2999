"""Chip smoke test of the PyTorch/CUDA port (`stableavatar_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failed check raises and the script
exits non-zero):

1. device   -- require CUDA, print the card's name and power limit, build the
               hand-written kernels from csrc/ and print the build seconds;
2. kernels  -- K1 (bf16 flash), K2 (int8-QK flash) and K5 (dual-context
               cross-attention) against their plain PyTorch versions at the
               main-path shapes and on a small ragged case, with times;
3. reference -- the fast-path DiT (2 blocks, full width) on a small window:
               the card's output against the CPU's (plain versions);
4. pipeline -- the port's generate_long at the full width of WAN_1_3B,
               512x512, Euler, overlap 15, 2 windows, 2 steps, random seeded
               weights on the W8A8 / int8-QK fast path; checks the video and
               the K2/K5 launch counts;
5. bf16     -- one dit_forward window on unprepared bf16 params
               (attn_quant="none"): 90 K1 launches.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# relative L2 and max-abs error limits of a kernel against its plain version
# (bf16 outputs; the two differ by summation order and bf16 rounding of P)
REL_TOL = 1e-2
ABS_TOL = 6e-2

KERNEL_SOURCES = {
    "flash_fwd_bf16": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                       "stableavatar_tpu/ops/flash_attention.py:217"),
    "flash_fwd_int8_qk": ("stableavatar_tpu_torch/csrc/flash_attention.cu",
                          "stableavatar_tpu/ops/flash_attention.py:548"),
    "dual_context": ("stableavatar_tpu_torch/csrc/cross_attention.cu",
                     "stableavatar_tpu/ops/cross_attention.py:112"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def compare(name: str, got, want) -> float:
    """Raise unless rel-L2 <= REL_TOL and max-abs <= ABS_TOL; return max-abs."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    mx = float((g - w).abs().max())
    log(f"  {name}: rel_l2={rel:.3e} max_abs={mx:.3e}")
    if not (rel <= REL_TOL and mx <= ABS_TOL):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(rel_l2 {rel:.3e} > {REL_TOL} or max_abs {mx:.3e} > {ABS_TOL})"
        )
    return mx


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port has no CPU run here")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # name, power limit: exactly as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from stableavatar_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {path}")
    for line in (path.parent / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            log(f"  ptxas: {line.split('for', 1)[1].strip()[:60]}")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}")


def _rand(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def phase_kernels(results):
    import torch

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa
    from stableavatar_tpu_torch.ops.rope import pack_split, rope_freqs_3d

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def record(name, shape_tag, err, ms, plain_ms):
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if ms is not None:
            entry["ms"], entry["plain_ms"] = ms, plain_ms
            log(f"  {name} {shape_tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # K2 and K1 at the DiT self-attention shape: [3, 21504, 12, 128]
    b, l, n, d = 3, 21 * 32 * 32, 12, 128
    q, k, v = (_rand(gen, (b, l, n, d), bf16) for _ in range(3))
    rope = pack_split(rope_freqs_3d((21, 32, 32), d, device="cuda"))
    scale = d ** -0.5
    q8, k8, sqk = fa.prepare_int8(q, k, rope, scale)
    got = fa._flash_int8_cuda(q8, k8, v, sqk, None)
    want = fa._flash_int8_plain(q8, k8, v, sqk)
    err = compare("flash_fwd_int8_qk [3,21504,12,128] rope", got, want)
    record("flash_fwd_int8_qk", "main", err,
           time_ms(lambda: fa._flash_int8_cuda(q8, k8, v, sqk, None), 5),
           time_ms(lambda: fa._flash_int8_plain(q8, k8, v, sqk), 3))
    del q8, k8, got, want

    got = fa._flash_fwd_cuda(q, k, v, None, scale)
    want = fa._flash_fwd_plain(q, k, v, None, scale)
    err = compare("flash_fwd_bf16 [3,21504,12,128]", got, want)
    record("flash_fwd_bf16", "main", err,
           time_ms(lambda: fa._flash_fwd_cuda(q, k, v, None, scale), 5),
           time_ms(lambda: fa._flash_fwd_plain(q, k, v, None, scale), 3))
    del got, want

    # K5 at the DiT cross-attention shape: text 512, image 257
    k1, v1 = (_rand(gen, (b, 512, n, d), bf16) for _ in range(2))
    k2, v2 = (_rand(gen, (b, 257, n, d), bf16) for _ in range(2))
    got = ca._dual_cuda(q, k1, v1, k2, v2, scale)
    want = ca._dual_plain(q, k1, v1, k2, v2, scale)
    err = compare("dual_context [3,21504,12,128] x (512, 257)", got, want)
    record("dual_context", "main", err,
           time_ms(lambda: ca._dual_cuda(q, k1, v1, k2, v2, scale), 5),
           time_ms(lambda: ca._dual_plain(q, k1, v1, k2, v2, scale), 3))
    del q, k, v, k1, v1, k2, v2, got, want

    # small ragged cases: Lq, Lk not tile multiples, per-batch k_lens,
    # both head dims the kernels take
    for (b, lq, n, d) in ((2, 3000, 2, 128), (1, 2100, 3, 64)):
        q, k, v = (_rand(gen, (b, lq, n, d), bf16) for _ in range(3))
        k_lens = torch.tensor([2500, 3000][:b], dtype=torch.int32, device="cuda").clamp(max=lq)
        tag = f"[{b},{lq},{n},{d}] k_lens={k_lens.tolist()}"
        scale = d ** -0.5
        q8, k8, sqk = fa.prepare_int8(q, k, None, scale)
        record("flash_fwd_int8_qk", tag, compare(
            f"flash_fwd_int8_qk {tag}", fa._flash_int8_cuda(q8, k8, v, sqk, k_lens),
            fa._flash_int8_plain(q8, k8, v, sqk, k_lens)), None, None)
        record("flash_fwd_bf16", tag, compare(
            f"flash_fwd_bf16 {tag}", fa._flash_fwd_cuda(q, k, v, k_lens, scale),
            fa._flash_fwd_plain(q, k, v, k_lens, scale)), None, None)
        k1, v1 = (_rand(gen, (b, 77, n, d), bf16) for _ in range(2))
        k2, v2 = (_rand(gen, (b, 33, n, d), bf16) for _ in range(2))
        record("dual_context", tag, compare(
            f"dual_context {tag} x (77, 33)", ca._dual_cuda(q, k1, v1, k2, v2, scale),
            ca._dual_plain(q, k1, v1, k2, v2, scale)), None, None)
    torch.cuda.synchronize()


def build_models(device):
    """Random 1.3B stack on the card from a seeded generator: DiT (bf16, plus
    its W8A8 fast-path preparation), VAE and CLIP (bf16), wav2vec (fp32).
    The zero-initialised DiT head and vocal k/v are replaced by small random
    weights (as the parity tests do) so the velocity is not identically 0."""
    import torch

    from stableavatar_tpu.config import CLIPConfig, VAEConfig, WAN_1_3B, Wav2Vec2Config
    from stableavatar_tpu_torch.models.clip import init_clip_visual
    from stableavatar_tpu_torch.models.dit import init_dit
    from stableavatar_tpu_torch.models.vae import init_vae
    from stableavatar_tpu_torch.models.wav2vec import init_wav2vec2
    from stableavatar_tpu_torch.pipelines.common import WanModels
    from stableavatar_tpu_torch.utils.fastpath import prepare_fast_params

    gen = torch.Generator(device=device).manual_seed(0)
    bf16 = torch.bfloat16
    cfg = WAN_1_3B
    dit = init_dit(gen, cfg, device, bf16)
    head = dit["head"]["head"]
    head["w"] = (torch.randn(head["w"].shape, generator=gen, device=device) * 0.01).to(bf16)
    for bp in dit["blocks"]:
        for name in ("k_vocal", "v_vocal"):
            w = bp["cross_attn"][name]["w"]
            bp["cross_attn"][name]["w"] = (
                torch.randn(w.shape, generator=gen, device=device) * 0.02).to(bf16)
    models = WanModels(
        dit_params=prepare_fast_params(dit, cfg, quant=True), dit_cfg=cfg,
        vae_params=init_vae(gen, VAEConfig(), device, bf16), vae_cfg=VAEConfig(),
        clip_params=init_clip_visual(gen, CLIPConfig(), device, bf16), clip_cfg=CLIPConfig(),
        wav2vec_params=init_wav2vec2(gen, Wav2Vec2Config(), device, torch.float32),
        wav2vec_cfg=Wav2Vec2Config(), rope_split=True, attn_quant="qk", device=device)
    return models, dit


def phase_reference(models):
    """The fast-path DiT (2 of the 30 blocks, full width) on a small window
    with 2,304 tokens, so self-attention takes K2 and cross-attention K5: the
    card's output against the same forward on the CPU (plain versions)."""
    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu() if torch.is_tensor(tree) else tree

    cfg = models.dit_cfg
    params = dict(models.dit_params, blocks=models.dit_params["blocks"][:2])
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((3, 16, 9, 32, 32), generator=gen, device="cuda").bfloat16()
    y = torch.randn((3, 20, 9, 32, 32), generator=gen, device="cuda").bfloat16()
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").bfloat16()
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").bfloat16()
    voc = torch.randn((1, 66, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 900.0, device="cuda")
    args = (x, t, text, clip, y, voc)
    kw = dict(video_sample_n_frames=33, vocal_cfg_tile=True, rope_split=True, attn_quant="qk")
    with torch.no_grad():
        got = dit_forward(params, cfg, *args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = dit_forward(to_cpu(params), cfg, *(a.cpu() for a in args), **kw)
        log(f"  CPU reference forward {time.perf_counter() - t0:.1f} s")
    g, w = got.float().cpu(), want.float()
    rel = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    log(f"  dit_forward 2 blocks, [3,16,9,32,32]: card vs CPU rel_l2={rel:.3e} "
        f"(|out| rms {float(w.square().mean().sqrt()):.3e})")
    # bf16 on both sides, rounded at different places, plus W8A8 rounding flips
    if not (torch.isfinite(g).all() and rel < 5e-2):
        raise AssertionError(f"card and CPU forwards disagree: rel_l2 {rel:.3e} >= 5e-2")


OVERLAP, N_WINDOWS = 15, 2


def pipeline_inputs(models):
    """Seeded inputs of generate_long at 512x512 whose audio makes N_WINDOWS
    windows of 21 latent frames (infer_length 27 for 2): a reference image,
    a 16 kHz waveform and a pre-encoded text context [3, 512, 4096]."""
    import numpy as np
    import torch

    infer_length = 21 + (21 - OVERLAP) * (N_WINDOWS - 1)
    n_samples = ((infer_length - 1) * 4 + 1) * (16000 // 25)
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((1, 3, 512, 512)).astype(np.float32) * 0.2
    wav = rng.standard_normal(n_samples).astype(np.float32) * 0.05
    text_ctx = torch.as_tensor(
        rng.standard_normal((3, models.dit_cfg.text_len, models.dit_cfg.text_dim)),
        dtype=torch.bfloat16, device="cuda")
    return dict(ref_image=ref, vocal_waveform=wav, text_ctx=text_ctx,
                overlap_window_length=OVERLAP, seed=42)


def phase_pipeline(models):
    """generate_long at 512x512, 2 windows (infer_length 27), 2 Euler steps."""
    import numpy as np
    import torch

    from stableavatar_tpu_torch.pipelines.long import generate_long
    from stableavatar_tpu_torch.utils.profiling import StepTimer

    steps, n_windows = 2, N_WINDOWS
    timer = StepTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = generate_long(models, num_inference_steps=steps, timer=timer, **pipeline_inputs(models))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, s in timer.summary().items():
        log(f"  phase {name}: {s['total_s']:.3f} s over {s['count']}")
    steps_s = timer.history["denoise_step"]
    log(f"  wall {wall:.2f} s; denoise steps {[round(s, 3) for s in steps_s]} s; last step "
        f"{steps_s[-1] / n_windows:.3f} s per window-step; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    video = out.videos
    if video.shape != (1, 3, 105, 512, 512):
        raise AssertionError(f"video shape {video.shape} != (1, 3, 105, 512, 512)")
    if not (np.isfinite(video).all() and video.min() >= 0.0 and video.max() <= 1.0):
        raise AssertionError("video values are not finite values in [0, 1]")
    lat = out.latents
    if not torch.isfinite(lat).all():
        raise AssertionError("latents are not finite")
    log(f"  video {video.shape} mean {video.mean():.4f} std {video.std():.4f}; "
        f"latents std {float(lat.std()):.4f}")
    return steps * n_windows


def phase_bf16(dit_params, cfg):
    """One dit_forward window at 1.3B / 512x512 on unprepared bf16 params with
    attn_quant="none": the CLI-default path, self- and cross-attention on K1."""
    import torch

    from stableavatar_tpu_torch.models.dit import dit_forward

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    x = torch.randn((3, 16, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    y = torch.randn((3, 20, 21, 64, 64), generator=gen, device="cuda").to(bf16)
    text = torch.randn((3, cfg.text_len, cfg.text_dim), generator=gen, device="cuda").to(bf16)
    clip = torch.randn((3, cfg.clip_tokens, cfg.clip_dim), generator=gen, device="cuda").to(bf16)
    voc = torch.randn((1, 161, cfg.audio_in_dim), generator=gen, device="cuda")
    t = torch.full((3,), 999.0, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dit_forward(dit_params, cfg, x, t, text, clip, y, voc, video_sample_n_frames=81,
                          vocal_cfg_tile=True, attn_quant="none")
        torch.cuda.synchronize()
    log(f"  bf16 dit_forward window: {time.perf_counter() - t0:.3f} s, out {tuple(out.shape)}")
    if tuple(out.shape) != (3, 16, 21, 64, 64) or not torch.isfinite(out).all():
        raise AssertionError("bf16 dit_forward output has the wrong shape or non-finite values")


def main() -> int:
    try:
        import torch
        import stableavatar_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the repository root",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port has no CPU run here",
              file=sys.stderr)
        return 1

    # the smoke drives device 0 only and reports the one card it used
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES to one of them)", file=sys.stderr)
        return 1

    results = {}
    phase_device()
    log("== kernels against their plain versions")
    phase_kernels(results)

    from stableavatar_tpu_torch.ops import cross_attention as ca
    from stableavatar_tpu_torch.ops import flash_attention as fa

    def counts():
        return {**fa.launch_counts, **ca.launch_counts}

    log("== random 1.3B / ViT-H / wav2vec2-base / VAE weights on the card")
    t0 = time.perf_counter()
    models, dit_bf16 = build_models("cuda")
    torch.cuda.synchronize()
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    log("== reference: card against CPU on a small input")
    phase_reference(models)

    # the main path: every launch count starts at 0 here and is read after
    # the last main-path phase; the comparisons above do not count
    for d in (fa.launch_counts, ca.launch_counts):
        for k in d:
            d[k] = 0
    layers = models.dit_cfg.num_layers
    log("== main path: generate_long, 1.3B, 512x512, Euler, overlap 15, 2 windows, 2 steps")
    n_dit_calls = phase_pipeline(models)
    c = counts()
    log(f"  launches: {c}")
    want = layers * n_dit_calls
    if c["flash_fwd_int8_qk"] != want or c["dual_context"] != want:
        raise AssertionError(f"expected {want} K2 and K5 launches, got {c}")
    log("== CLI-default bf16 path: dit_forward, attn_quant='none'")
    phase_bf16(dit_bf16, models.dit_cfg)
    launches = counts()
    k1 = launches["flash_fwd_bf16"] - c["flash_fwd_bf16"]
    log(f"  K1 launches: {k1}")
    if k1 != 3 * layers:
        raise AssertionError(f"expected {3 * layers} K1 launches (1 self + 2 cross per layer), got {k1}")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels of the main path never launched: {idle}")

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = results.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": r.get("max_abs_err"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
