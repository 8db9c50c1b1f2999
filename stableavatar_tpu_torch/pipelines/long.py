"""Infinite-length sliding-window generation, port of
`stableavatar_tpu/pipelines/long.py`.

The window planners and the TeaCache plan are host-side, copied from the
JAX package.  Where the JAX package runs one jitted sweep per denoise step
(`_sweep_step` for Euler, `_sweep_step_tc` with TeaCache, `_sweep_step_ms`
for DPM++ / UniPC), the port runs one eager `_sweep_step` that covers all
three: each window is CFG-tripled, denoised by the DiT (or, on a TeaCache
skip, by the cached block-stack residual), dual-CFG combined, stepped in
fp32 by the solver, cross-faded into the previous window's tail over the
overlap and written into the next latent buffer.  As-built behaviour kept:
the final window is shifted back to full size, the final window's audio is
truncated at the track end, latents are bf16 between steps, each window
carries its own multistep history, and the TeaCache counter advances once
per window call.

Under a mesh (`parallel/mesh.py:mesh_context`) every rank runs this same
sweep on the same latents, noise and solver state; only the DiT inside it
splits its work over the ranks (`models/dit.py`, `models.attn_impl`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from stableavatar_tpu_torch.models.dit import dit_forward, dit_forward_skip, dit_time_e0
from stableavatar_tpu_torch.models.vae import decode_video_segments
from stableavatar_tpu_torch.pipelines.common import (
    WanModels,
    encode_prompts,
    extract_vocal_features,
    guidance_combine_long,
    prepare_conditioning,
    resolve_device,
)
from stableavatar_tpu_torch.schedulers.flow_match import flow_match_timesteps
from stableavatar_tpu_torch.schedulers.fm_solvers import (
    dpm_apply,
    dpm_coeffs,
    unipc_apply,
    unipc_coeffs,
)
from stableavatar_tpu_torch.utils.color_correction import match_and_blend_colors
from stableavatar_tpu_torch.utils.profiling import span


def overlap_weights(n: int, scheme: str = "uniform") -> np.ndarray:
    """Cross-fade ramp 0 -> 1 over the overlap (weights of the NEW window)."""
    if scheme == "uniform":
        w = np.arange(n, dtype=np.float32) / max(n - 1, 1)
    elif scheme == "log":
        init = np.linspace(0.0, 1.0, n, dtype=np.float32)
        init = np.log1p(init * (np.e - 1.0))
        w = (init - init.min()) / (init.max() - init.min())
    else:
        raise ValueError(f"unknown overlapping_weight_scheme {scheme}")
    return w


def plan_windows(infer_length: int, frames_per_batch: int, overlap: int) -> List[Tuple[int, int]]:
    """Static window schedule [(start, end)); the final window is shifted
    back so every window is full-size."""
    if frames_per_batch >= infer_length:
        return [(0, infer_length)]
    if overlap >= frames_per_batch:
        raise ValueError(
            f"overlap_window_length ({overlap}) must be smaller than the "
            f"latent window ({frames_per_batch} frames)"
        )
    windows = []
    index_start = 0
    while True:
        if index_start + frames_per_batch >= infer_length:
            windows.append((infer_length - frames_per_batch, infer_length))
            break
        windows.append((index_start, index_start + frames_per_batch))
        index_start = index_start + (frames_per_batch - overlap)
    return windows


def plan_audio_slices(windows, infer_length: int, samples_per_frame: int,
                      total_samples: int) -> List[np.ndarray]:
    """Per-window raw-sample indices: non-final windows take (e-s)*4 video
    frames of samples with modular wrap; the final window is truncated at
    the end of the audio track."""
    out = []
    for s, e in windows:
        start = s * 4 * samples_per_frame
        if e == infer_length:
            idx = np.arange(start, max(total_samples, start + 1))
        else:
            idx = np.arange(start, start + (e - s) * 4 * samples_per_frame)
        out.append(np.mod(idx, total_samples))
    return out


def precompute_teacache_plan(teacache, e0_steps, n_windows: int):
    """Simulate the controller over the (step x window) call sequence and
    return one tuple of compute flags per step: the decisions the per-window
    loop would make (no skip before a residual exists).  A step whose
    windows disagree computes all of them, and its would-be skips leave the
    skip count (as in the JAX package, whose sweep compiles one program per
    flag pattern)."""
    plan = []
    have_residual = False
    for e0 in e0_steps:
        flags = []
        for _ in range(n_windows):
            compute = teacache.plan(e0, can_skip=have_residual)
            if compute:
                have_residual = True
            flags.append(bool(compute))
        plan.append(tuple(flags))

    canon = []
    for flags in plan:
        if all(flags) or not any(flags):
            canon.append(flags)
        else:
            teacache.skipped_calls -= sum(1 for f in flags if not f)
            canon.append(tuple(True for _ in flags))
    return canon


@dataclasses.dataclass
class LongPipelineOutput:
    videos: Optional[np.ndarray]  # [B, 3, T, H, W] in [0, 1]
    latents: Optional[torch.Tensor] = None


def _sweep_step(models: WanModels, latents_all, y_full, text_ctx, clip_ctx, vocal_embs,
                t, sigma, sigma_next, ramp, windows, overlap, text_scale, audio_scale,
                blend: bool, solver: str = "euler", ms_state=None, coeffs=None,
                compute_flags=None, residual=None):
    """One denoise step across all windows (the DiT through
    `models.streamed_dit` when it is set).

    solver "euler" steps x + (sigma_next - sigma) v; "dpm" / "unipc" apply
    the multistep update with this step's `coeffs` and the per-window
    history `ms_state` (dict of per-window lists), updated in place.
    `compute_flags` (TeaCache) says per window whether the DiT runs, with
    its block-stack delta kept as `residual`, or the cached residual is
    replayed.  Returns (new bf16 latents, residual)."""
    cfg, temporal_ratio = models.dit_cfg, models.vae_cfg.temporal_compression_ratio
    pred = torch.zeros_like(latents_all)
    tb = torch.full((3,), float(t), dtype=torch.float32, device=latents_all.device)
    step = float(np.float32(sigma_next) - np.float32(sigma))
    prev_end = None
    for wi, (s, e) in enumerate(windows):
        with span("sa.window"):
            f = e - s
            lat_win = latents_all[:, :, s:e]
            lat3 = torch.cat([lat_win] * 3, dim=0).to(torch.bfloat16)
            with span("sa.dit"):
                if compute_flags is not None and not compute_flags[wi]:
                    noise_pred = dit_forward_skip(models.dit_params, cfg, lat3, tb,
                                                  y_full[:, :, :f], residual)
                elif models.streamed_dit is not None:
                    noise_pred = models.streamed_dit(
                        lat3, tb, text_ctx, clip_ctx, y_full[:, :, :f], vocal_embs[wi],
                        video_sample_n_frames=(f - 1) * temporal_ratio + 1, vocal_cfg_tile=True)
                else:
                    out = dit_forward(
                        models.dit_params, cfg, lat3, tb, text_ctx, clip_ctx, y_full[:, :, :f],
                        vocal_embs[wi], video_sample_n_frames=(f - 1) * temporal_ratio + 1,
                        vocal_cfg_tile=True, rope_split=models.rope_split,
                        attn_quant=models.attn_quant, attn_impl=models.attn_impl,
                        honor_vocal_k_lens=models.honor_vocal_k_lens,
                        return_residual=compute_flags is not None)
                    noise_pred, residual = out if compute_flags is not None else (out, residual)
            v = guidance_combine_long(noise_pred, text_scale, audio_scale)
            if solver == "euler":
                new_lat = lat_win.float() + step * v
            elif solver == "dpm":
                new_lat, x0 = dpm_apply(lat_win, v, sigma, ms_state["x0_prev"][wi],
                                        ms_state["x0_prev2"][wi], **coeffs)
                ms_state["x0_prev2"][wi] = ms_state["x0_prev"][wi]
                ms_state["x0_prev"][wi] = x0
            else:
                new_lat, x0, corrected = unipc_apply(
                    lat_win, v, sigma, ms_state["x0_prev"][wi], ms_state["x0_prev2"][wi],
                    ms_state["last_sample"][wi], x0_prev3=ms_state["x0_prev3"][wi], **coeffs)
                ms_state["x0_prev3"][wi] = ms_state["x0_prev2"][wi]
                ms_state["x0_prev2"][wi] = ms_state["x0_prev"][wi]
                ms_state["x0_prev"][wi] = x0
                ms_state["last_sample"][wi] = corrected
            new_lat = new_lat.to(torch.bfloat16)
            if s != 0 and blend:
                prev_tail = pred[:, :, prev_end - overlap : prev_end]
                head = new_lat[:, :, :overlap]
                blended = head * ramp.to(head.dtype) + prev_tail * (1 - ramp).to(head.dtype)
                new_lat = torch.cat([blended, new_lat[:, :, overlap:]], dim=2)
            pred[:, :, s:e] = new_lat
            prev_end = e
    return pred, residual


SCHEDULERS = ("euler", "flow", "dpm++", "dpm-solver++", "dpm", "unipc")


def _solver_setup(scheduler, sched, solver_order, solver_type, n_windows, shape, device):
    """(solver kind, per-step coefficients, zeroed per-window history)."""
    if scheduler in ("euler", "flow"):
        return "euler", None, None

    def zeros():
        return [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(n_windows)]

    if scheduler in ("dpm++", "dpm-solver++", "dpm"):
        co = [dpm_coeffs(sched, i, solver_order, solver_type or "midpoint")
              for i in range(sched.num_steps)]
        return "dpm", co, {"x0_prev": zeros(), "x0_prev2": zeros()}
    co, prev_order = [], 1
    for i in range(sched.num_steps):
        c, prev_order = unipc_coeffs(sched, i, solver_order, prev_order, solver_type or "bh2")
        co.append(c)
    return "unipc", co, {k: zeros() for k in ("x0_prev", "x0_prev2", "x0_prev3",
                                              "last_sample")}


def generate_long(
    models: WanModels,
    *,
    ref_image,  # [1, 3, H, W] in [-1, 1] (numpy or tensor)
    vocal_waveform,  # [S] raw 16 kHz samples (numpy)
    prompt: str = "",
    negative_prompt: str = "",
    text_ctx: Optional[torch.Tensor] = None,  # pre-encoded [3, text_len, text_dim]
    num_inference_steps: int = 50,
    text_guide_scale: float = 3.0,
    audio_guide_scale: float = 5.0,
    clip_length: int = 81,
    overlap_window_length: int = 15,
    overlapping_weight_scheme: str = "uniform",
    scheduler: str = "euler",  # "euler" | "dpm++" | "unipc"
    solver_order: int = 2,
    solver_type: Optional[str] = None,  # dpm++: midpoint | heun; unipc: bh1 | bh2
    fps: int = 25,
    sr: int = 16000,
    seed: int = 42,
    shift: float = 5.0,
    output_type: str = "numpy",
    timer=None,  # optional utils.profiling.StepTimer
    initial_latents=None,  # optional [1, 16, infer_length, lh, lw] noise
    step_callback=None,  # optional fn(step_index, latents_all)
    color_correction_strength: float = 0.0,  # opt-in LAB match to the reference image
    frame_sink=None,  # optional fn([1, 3, T, H, W] uint8 segment): stream frames out
) -> LongPipelineOutput:
    """Audio-driven video of any length (Euler, DPM++ or UniPC, optionally
    with `models.teacache`)."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    if models.streamed_dit is not None and (scheduler not in ("euler", "flow")
                                            or models.teacache is not None):
        # as the JAX package: the streamed forward serves the Euler sweep
        # without TeaCache (the reference's sequential offload runs Euler)
        raise ValueError("sequential_cpu_offload (streamed DiT) currently supports the euler "
                         "scheduler without TeaCache")
    device = resolve_device(models.device)
    phase = (timer.follow(device).phase if timer is not None
             else (lambda name: contextlib.nullcontext()))
    ref_image = torch.as_tensor(ref_image, dtype=torch.float32, device=device)
    h_img, w_img = ref_image.shape[-2:]
    vae_cfg = models.vae_cfg

    frames_per_batch = (clip_length - 1) // vae_cfg.temporal_compression_ratio + 1
    samples_per_frame = int(sr / fps)
    total_samples = int(np.shape(vocal_waveform)[0])
    total_frames = int(total_samples / samples_per_frame)
    infer_length = (total_frames - 1) // vae_cfg.temporal_compression_ratio + 1
    sched = flow_match_timesteps(num_inference_steps, shift=shift)

    lh = h_img // vae_cfg.spatial_compression_ratio
    lw = w_img // vae_cfg.spatial_compression_ratio
    if initial_latents is not None:
        latents_all = torch.as_tensor(initial_latents, dtype=torch.float32, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        latents_all = torch.randn((1, vae_cfg.z_dim, infer_length, lh, lw), generator=gen,
                                  device=device, dtype=torch.float32)
    latents_all = latents_all.to(torch.bfloat16)

    with phase("text_encode"):
        if text_ctx is None:
            text_ctx = encode_prompts(models, prompt, negative_prompt)
        text_ctx = torch.as_tensor(text_ctx, device=device)
    with phase("conditioning"):
        clip_ctx, y_full = prepare_conditioning(models, ref_image, clip_length, cfg_batch=3)

    windows = plan_windows(infer_length, frames_per_batch, overlap_window_length)
    audio_slices = plan_audio_slices(windows, infer_length, samples_per_frame, total_samples)
    with phase("wav2vec"):
        wav = np.asarray(vocal_waveform, dtype=np.float32)
        vocal_embs = [extract_vocal_features(models, wav[idx]) for idx in audio_slices]

    ramp = None
    if overlap_window_length > 0:
        w = overlap_weights(overlap_window_length, overlapping_weight_scheme)
        ramp = torch.as_tensor(w, device=device)[None, None, :, None, None]

    # every window is full-size (plan_windows), so one history shape serves all
    fpb0 = windows[0][1] - windows[0][0]
    solver, co_steps, ms_state = _solver_setup(
        scheduler, sched, solver_order, solver_type, len(windows),
        (1, vae_cfg.z_dim, fpb0, lh, lw), device)

    with torch.no_grad():
        teacache, tc_plan, residual = models.teacache, None, None
        if teacache is not None:
            teacache.reset()
            # the whole skip schedule is a function of e0(t): decide it up front
            e0_all = dit_time_e0(models.dit_params, models.dit_cfg,
                                 torch.as_tensor(np.asarray(sched.timesteps), dtype=torch.float32,
                                                 device=device))
            tc_plan = precompute_teacache_plan(
                teacache, [e0_all[i : i + 1] for i in range(sched.num_steps)], len(windows))
            l_tokens = fpb0 * (lh // 2) * (lw // 2)
            residual = torch.zeros((3, l_tokens, models.dit_cfg.dim), dtype=torch.bfloat16,
                                   device=device)

        for i in range(sched.num_steps):
            with phase("denoise_step"):
                latents_all, residual = _sweep_step(
                    models, latents_all, y_full, text_ctx, clip_ctx, vocal_embs,
                    sched.timesteps[i], sched.sigmas[i], sched.sigmas[i + 1], ramp, windows,
                    int(overlap_window_length), float(text_guide_scale),
                    float(audio_guide_scale), blend=bool(i != 0 and ramp is not None),
                    solver=solver, ms_state=ms_state,
                    coeffs=co_steps[i] if co_steps is not None else None,
                    compute_flags=tc_plan[i] if tc_plan is not None else None,
                    residual=residual)
            if step_callback is not None:
                with span("sa.step_callback"):
                    step_callback(i, latents_all)

        latents = latents_all.float()
        if output_type == "latent":
            return LongPipelineOutput(videos=None, latents=latents)

        # decode in bf16, uint8 on the device (4x fewer bytes to the host).
        # The phase ends when the first segment is on the host (the card
        # has decoded two: the first and the one enqueued behind it); the
        # rest decode while the host takes each segment, under
        # "video_transfer" (models/vae.py:decode_video_segments)
        with phase("vae_decode"):
            segs = decode_video_segments(models.vae_params, latents_all.to(torch.bfloat16),
                                         vae_cfg, out_uint8=True)
            first = next(segs)
        segs_u8 = itertools.chain([first], segs)

    def correct(video: np.ndarray) -> np.ndarray:
        # opt-in LAB match of the decoded frames to the reference image
        if color_correction_strength <= 0.0:
            return video
        ref_np = ref_image.cpu().numpy()[:, :, None]  # [1, 3, 1, H, W]
        return np.clip((match_and_blend_colors(video * 2.0 - 1.0, ref_np,
                                               color_correction_strength) + 1.0) / 2.0,
                       0.0, 1.0)

    if frame_sink is not None:
        # unbounded-length output: each uint8 segment goes to the sink, so
        # host memory stays O(segment)
        with phase("video_transfer"):
            for seg in segs_u8:
                seg = seg.numpy()
                if color_correction_strength > 0.0:
                    seg = (correct(seg.astype(np.float32) / 255.0) * 255.0).round().astype(np.uint8)
                frame_sink(seg)
        return LongPipelineOutput(videos=None, latents=latents)

    with phase("video_transfer"):
        video = torch.cat(list(segs_u8), dim=2).numpy().astype(np.float32) / 255.0
    return LongPipelineOutput(videos=correct(video), latents=latents)
