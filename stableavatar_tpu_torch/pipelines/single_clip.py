"""Single-clip (81-frame) generation pipeline, the validation path; port of
`stableavatar_tpu/pipelines/single_clip.py`.

One clip, the text CFG triple [neg, pos, pos], the audio tiled inside the
DiT as [0, v, v], and the dual-CFG combine with the roles of the two scales
swapped (`pipelines/common.py:guidance_combine_single`).  Euler steps here;
DPM++ and UniPC through `schedulers/fm_solvers.py`; TeaCache on the plan of
`pipelines/long.py:precompute_teacache_plan` with the clip as its one
window; the decode is the segmented one of `generate_long`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stableavatar_tpu_torch.models.dit import dit_forward, dit_forward_skip, dit_time_e0
from stableavatar_tpu_torch.models.vae import decode_video_segmented
from stableavatar_tpu_torch.pipelines.common import (
    WanModels,
    encode_prompt_ids,
    extract_vocal_features,
    guidance_combine_single,
    prepare_conditioning,
    resolve_device,
)
from stableavatar_tpu_torch.pipelines.long import precompute_teacache_plan
from stableavatar_tpu_torch.schedulers.flow_match import flow_match_timesteps
from stableavatar_tpu_torch.schedulers.fm_solvers import (
    FlowDPMSolverMultistep,
    FlowUniPCMultistep,
    MultistepState,
)


def _dit_kw(models: WanModels, clip_length: int) -> dict:
    return dict(video_sample_n_frames=clip_length, vocal_cfg_tile=True,
                rope_split=models.rope_split, attn_quant=models.attn_quant,
                attn_impl=models.attn_impl, honor_vocal_k_lens=models.honor_vocal_k_lens)


def _cfg3(models: WanModels, latents, y, text_ctx, clip_ctx, vocal_emb, t, clip_length,
          **kw):
    """The DiT on the CFG-tripled clip at timestep t."""
    lat3 = torch.cat([latents] * 3, dim=0).to(torch.bfloat16)
    tb = torch.full((3,), float(t), dtype=torch.float32, device=latents.device)
    return dit_forward(models.dit_params, models.dit_cfg, lat3, tb, text_ctx, clip_ctx, y,
                       vocal_emb, **_dit_kw(models, clip_length), **kw)


def _clip_step(models: WanModels, latents, y, text_ctx, clip_ctx, vocal_emb, t, sigma,
               sigma_next, clip_length: int, text_scale: float, audio_scale: float):
    """One Euler step of the clip; returns bf16 latents."""
    v = _clip_velocity(models, latents, y, text_ctx, clip_ctx, vocal_emb, t, clip_length,
                       text_scale, audio_scale)
    step = float(np.float32(sigma_next) - np.float32(sigma))
    return (latents.float() + step * v).to(torch.bfloat16)


def _clip_velocity(models: WanModels, latents, y, text_ctx, clip_ctx, vocal_emb, t,
                   clip_length: int, text_scale: float, audio_scale: float):
    """The CFG-combined velocity (for the multistep solvers)."""
    noise_pred = _cfg3(models, latents, y, text_ctx, clip_ctx, vocal_emb, t, clip_length)
    return guidance_combine_single(noise_pred, text_scale, audio_scale)


def _clip_velocity_tc(models: WanModels, latents, y, text_ctx, clip_ctx, vocal_emb, residual,
                      t, clip_length: int, text_scale: float, audio_scale: float,
                      compute: bool = True):
    """TeaCache's velocity: a computed step keeps the block-stack residual,
    a skipped one replays it (`dit_forward_skip`).  Returns (v, residual)."""
    if compute:
        noise_pred, residual = _cfg3(models, latents, y, text_ctx, clip_ctx, vocal_emb, t,
                                     clip_length, return_residual=True)
    else:
        lat3 = torch.cat([latents] * 3, dim=0).to(torch.bfloat16)
        tb = torch.full((3,), float(t), dtype=torch.float32, device=latents.device)
        noise_pred = dit_forward_skip(models.dit_params, models.dit_cfg, lat3, tb, y, residual)
    return guidance_combine_single(noise_pred, text_scale, audio_scale), residual


@dataclasses.dataclass
class SingleClipOutput:
    videos: Optional[np.ndarray]  # [1, 3, T, H, W] in [0, 1]
    latents: Optional[torch.Tensor] = None


def generate_single_clip(
    models: WanModels,
    *,
    ref_image,  # [1, 3, H, W] in [-1, 1] (numpy or tensor)
    vocal_waveform,  # [S] raw 16 kHz samples (numpy)
    prompt_ids=None,  # ([L], [L]) tokenised positive prompt
    negative_prompt_ids=None,
    text_ctx: Optional[torch.Tensor] = None,  # [3, text_len, text_dim] override
    num_inference_steps: int = 50,
    prompt_cfg_scale: float = 3.0,
    audio_cfg_scale: float = 5.0,
    clip_length: int = 81,
    seed: int = 42,
    shift: float = 5.0,
    scheduler: str = "euler",  # "euler" | "dpm++" | "unipc"
    solver_order: int = 2,
    solver_type: Optional[str] = None,  # dpm++: midpoint | heun; unipc: bh1 | bh2
    output_type: str = "numpy",
    initial_latents=None,  # [1, 16, Tl, h, w] noise override
    step_callback=None,  # fn(step_index, post-step fp32 latents)
) -> SingleClipOutput:
    """One clip of `clip_length` frames driven by `vocal_waveform`."""
    if scheduler not in ("euler", "dpm++", "unipc"):
        raise ValueError(f"unknown scheduler {scheduler!r}")
    device = resolve_device(models.device)
    vae_cfg = models.vae_cfg
    ref_image = torch.as_tensor(ref_image, dtype=torch.float32, device=device)
    h_img, w_img = ref_image.shape[-2:]
    tl = (clip_length - 1) // vae_cfg.temporal_compression_ratio + 1
    sched = flow_match_timesteps(num_inference_steps, shift=shift)
    lh = h_img // vae_cfg.spatial_compression_ratio
    lw = w_img // vae_cfg.spatial_compression_ratio
    if initial_latents is not None:
        latents = torch.as_tensor(initial_latents, dtype=torch.float32, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        latents = torch.randn((1, vae_cfg.z_dim, tl, lh, lw), generator=gen, device=device,
                              dtype=torch.float32)
    latents = latents.to(torch.bfloat16)

    with torch.no_grad():
        if text_ctx is None:
            # the CFG triple [neg, pos, pos]
            (ids_p, mask_p), (ids_n, mask_n) = prompt_ids, negative_prompt_ids
            text_ctx = encode_prompt_ids(models, np.stack([ids_n, ids_p, ids_p]),
                                         np.stack([mask_n, mask_p, mask_p]))
        text_ctx = torch.as_tensor(text_ctx, device=device)
        clip_ctx, y = prepare_conditioning(models, ref_image, clip_length, cfg_batch=3)
        vocal_emb = extract_vocal_features(models, np.asarray(vocal_waveform, np.float32))

        # TeaCache: the skip plan over the steps, the clip as one window
        teacache, tc_plan, residual = models.teacache, None, None
        if teacache is not None:
            teacache.reset()
            e0_all = dit_time_e0(models.dit_params, models.dit_cfg,
                                 torch.as_tensor(np.asarray(sched.timesteps), dtype=torch.float32,
                                                 device=device))
            tc_plan = precompute_teacache_plan(
                teacache, [e0_all[i : i + 1] for i in range(sched.num_steps)], 1)
            residual = torch.zeros((3, tl * (lh // 2) * (lw // 2), models.dit_cfg.dim),
                                   dtype=torch.bfloat16, device=device)

        args = (y, text_ctx, clip_ctx, vocal_emb)
        scales = (clip_length, float(prompt_cfg_scale), float(audio_cfg_scale))

        def velocity(i, t):
            nonlocal residual
            if tc_plan is None:
                return _clip_velocity(models, latents, *args, t, *scales)
            v, residual = _clip_velocity_tc(models, latents, *args, residual, t, *scales,
                                            compute=tc_plan[i][0])
            return v

        if scheduler == "euler":
            for i in range(sched.num_steps):
                if tc_plan is None:
                    latents = _clip_step(models, latents, *args, sched.timesteps[i],
                                         sched.sigmas[i], sched.sigmas[i + 1], *scales)
                else:
                    step = float(np.float32(sched.sigmas[i + 1]) - np.float32(sched.sigmas[i]))
                    v = velocity(i, sched.timesteps[i])
                    latents = (latents.float() + step * v).to(torch.bfloat16)
                if step_callback is not None:
                    step_callback(i, latents.float())
        else:
            solver_cls = {"dpm++": FlowDPMSolverMultistep, "unipc": FlowUniPCMultistep}[scheduler]
            kw = {"solver_type": solver_type} if solver_type else {}
            solver = solver_cls(num_inference_steps, shift=shift, order=solver_order, **kw)
            state = MultistepState()
            for i in range(solver.sched.num_steps):
                lat_f, state = solver.step(velocity(i, solver.timesteps[i]), i, latents, state)
                latents = lat_f.to(torch.bfloat16)
                if step_callback is not None:
                    step_callback(i, latents.float())

        lat_f32 = latents.float()
        if output_type == "latent":
            return SingleClipOutput(videos=None, latents=lat_f32)
        segs_u8 = decode_video_segmented(models.vae_params, latents, vae_cfg, out_uint8=True)
    video = torch.cat(segs_u8, dim=2).cpu().numpy().astype(np.float32) / 255.0
    return SingleClipOutput(videos=video, latents=lat_f32)
