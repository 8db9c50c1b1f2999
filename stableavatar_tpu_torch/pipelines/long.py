"""Infinite-length sliding-window generation, port of
`stableavatar_tpu/pipelines/long.py` (the Euler path).

The window planners are numpy, copied from the JAX package.  Where the JAX
package runs one jitted `_sweep_step` per denoise step (all windows, latents
donated), the port runs the same sweep eagerly: each window is CFG-tripled,
denoised by the DiT, dual-CFG combined, Euler-stepped in fp32, cross-faded
into the previous window's tail over the overlap and written into the next
latent buffer.  As-built behaviour kept: the final window is shifted back
to full size, the final window's audio is truncated at the track end, and
latents are bf16 between steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from stableavatar_tpu_torch.models.dit import dit_forward
from stableavatar_tpu_torch.models.vae import decode_video_segmented
from stableavatar_tpu_torch.pipelines.common import (
    WanModels,
    encode_prompts,
    extract_vocal_features,
    guidance_combine_long,
    prepare_conditioning,
)
from stableavatar_tpu_torch.schedulers.flow_match import flow_match_timesteps


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


@dataclasses.dataclass
class LongPipelineOutput:
    videos: Optional[np.ndarray]  # [B, 3, T, H, W] in [0, 1]
    latents: Optional[torch.Tensor] = None


def _sweep_step(models: WanModels, latents_all, y_full, text_ctx, clip_ctx, vocal_embs,
                t, sigma, sigma_next, ramp, windows, overlap, text_scale, audio_scale,
                blend: bool):
    """One Euler step across all windows; returns the new bf16 latents."""
    cfg, temporal_ratio = models.dit_cfg, models.vae_cfg.temporal_compression_ratio
    pred = torch.zeros_like(latents_all)
    tb = torch.full((3,), float(t), dtype=torch.float32, device=latents_all.device)
    step = float(np.float32(sigma_next) - np.float32(sigma))
    prev_end = None
    for wi, (s, e) in enumerate(windows):
        f = e - s
        lat_win = latents_all[:, :, s:e]
        lat3 = torch.cat([lat_win] * 3, dim=0).to(torch.bfloat16)
        noise_pred = dit_forward(
            models.dit_params, cfg, lat3, tb, text_ctx, clip_ctx, y_full[:, :, :f],
            vocal_embs[wi], video_sample_n_frames=(f - 1) * temporal_ratio + 1,
            vocal_cfg_tile=True, rope_split=models.rope_split, attn_quant=models.attn_quant,
            honor_vocal_k_lens=models.honor_vocal_k_lens)
        noise_pred = guidance_combine_long(noise_pred, text_scale, audio_scale)
        new_lat = (lat_win.float() + step * noise_pred).to(torch.bfloat16)
        if s != 0 and blend:
            prev_tail = pred[:, :, prev_end - overlap : prev_end]
            head = new_lat[:, :, :overlap]
            blended = head * ramp.to(head.dtype) + prev_tail * (1 - ramp).to(head.dtype)
            new_lat = torch.cat([blended, new_lat[:, :, overlap:]], dim=2)
        pred[:, :, s:e] = new_lat
        prev_end = e
    return pred


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
    scheduler: str = "euler",
    fps: int = 25,
    sr: int = 16000,
    seed: int = 42,
    shift: float = 5.0,
    output_type: str = "numpy",
    timer=None,  # optional utils.profiling.StepTimer
    initial_latents=None,  # optional [1, 16, infer_length, lh, lw] noise
    step_callback=None,  # optional fn(step_index, latents_all)
) -> LongPipelineOutput:
    """Audio-driven video of any length (Euler)."""
    if scheduler not in ("euler", "flow"):
        raise NotImplementedError(
            f"scheduler {scheduler!r} is not ported yet (ROADMAP queue 1, item 8: "
            "schedulers/fm_solvers.py); only the Euler path is")
    if models.teacache is not None:
        raise NotImplementedError(
            "TeaCache is not ported yet (ROADMAP queue 1, item 8: models/teacache.py)")
    if models.streamed_dit is not None:
        raise NotImplementedError(
            "the host-streamed DiT is not ported yet (ROADMAP queue 1, item 8: "
            "models/streaming.py)")
    device = torch.device(models.device)
    phase = timer.phase if timer is not None else (lambda name: contextlib.nullcontext())
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

    with torch.no_grad():
        for i in range(sched.num_steps):
            with phase("denoise_step"):
                latents_all = _sweep_step(
                    models, latents_all, y_full, text_ctx, clip_ctx, vocal_embs,
                    sched.timesteps[i], sched.sigmas[i], sched.sigmas[i + 1], ramp, windows,
                    int(overlap_window_length), float(text_guide_scale),
                    float(audio_guide_scale), blend=bool(i != 0 and ramp is not None))
            if step_callback is not None:
                step_callback(i, latents_all)

        latents = latents_all.float()
        if output_type == "latent":
            return LongPipelineOutput(videos=None, latents=latents)

        # decode in bf16, uint8 on the device (4x fewer bytes to the host)
        with phase("vae_decode"):
            segs_u8 = decode_video_segmented(models.vae_params, latents_all.to(torch.bfloat16),
                                             vae_cfg, out_uint8=True)
    with phase("video_transfer"):
        video = torch.cat(segs_u8, dim=2).cpu().numpy().astype(np.float32) / 255.0
    return LongPipelineOutput(videos=video, latents=latents)
