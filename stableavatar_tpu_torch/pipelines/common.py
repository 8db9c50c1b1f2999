"""Shared pipeline machinery: model bundle, conditioning, CFG (port of
`stableavatar_tpu/pipelines/common.py`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from stableavatar_tpu.config import CLIPConfig, DiTConfig, VAEConfig, Wav2Vec2Config
from stableavatar_tpu_torch.models.clip import clip_visual_forward, preprocess_reference_image
from stableavatar_tpu_torch.models.vae import encode_video
from stableavatar_tpu_torch.models.wav2vec import normalize_waveform, wav2vec2_forward


@dataclasses.dataclass
class WanModels:
    """All parameter trees and configs of the generation stack, on `device`."""

    dit_params: Any
    dit_cfg: DiTConfig
    vae_params: Any
    vae_cfg: VAEConfig = VAEConfig()
    clip_params: Any = None
    clip_cfg: CLIPConfig = CLIPConfig()
    wav2vec_params: Any = None
    wav2vec_cfg: Wav2Vec2Config = Wav2Vec2Config()
    # inference fast path: dit_params prepared by utils/fastpath.py
    rope_split: bool = False
    attn_quant: str = "none"
    # False reproduces the reference's SDPA deployment (vocal padding masks dropped)
    honor_vocal_k_lens: bool = True
    device: Any = "cpu"
    # not ported yet; generate_long raises when either is set
    teacache: Any = None
    streamed_dit: Any = None


def encode_prompts(models: WanModels, prompt: str, negative_prompt: str = ""):
    """The T5 text encoder is not ported yet: pass a pre-encoded `text_ctx`."""
    raise NotImplementedError(
        "encode_prompts needs the umT5 encoder, which the port does not have yet "
        "(ROADMAP queue 1: T5 and the CLI); pass text_ctx [3, text_len, text_dim]"
    )


def prepare_conditioning(models: WanModels, ref_image: torch.Tensor, clip_length: int,
                         cfg_batch: int = 3):
    """Returns (clip_context [cfg, 257, clip_dim], y [cfg, 20, Tl, h, w]): CLIP
    features of the reference image, and the 4-channel first-frame mask
    packed with the VAE latents of the first-frame-then-zeros video."""
    h_img, w_img = ref_image.shape[-2:]
    clip_in = preprocess_reference_image(ref_image, models.clip_cfg)
    # CLIP and the VAE encode run in the image's dtype (fp32), as in the JAX
    # package, whose linears and convs cast the weights to the activation dtype
    clip_ctx = clip_visual_forward(models.clip_params, models.clip_cfg, clip_in)
    clip_ctx = torch.cat([clip_ctx] * cfg_batch, dim=0)

    video = torch.cat([ref_image[:, :, None],
                       ref_image.new_zeros((1, 3, clip_length - 1, h_img, w_img))], dim=2)
    masked_latents = encode_video(models.vae_params, video, models.vae_cfg)
    tl, lh, lw = masked_latents.shape[2:]

    msk = torch.zeros((1, clip_length, lh, lw), device=ref_image.device)
    msk[:, 0] = 1.0
    msk = torch.cat([msk[:, 0:1].repeat(1, 4, 1, 1), msk[:, 1:]], dim=1)
    msk = msk.reshape(1, msk.shape[1] // 4, 4, lh, lw).transpose(1, 2)
    y = torch.cat([msk.to(masked_latents.dtype), masked_latents], dim=1)
    return clip_ctx, torch.cat([y] * cfg_batch, dim=0)


def extract_vocal_features(models: WanModels, waveform: np.ndarray,
                           do_normalize: Optional[bool] = None) -> torch.Tensor:
    """Raw 16 kHz samples -> wav2vec hidden states [1, L, hidden]."""
    wav = torch.as_tensor(np.asarray(waveform, dtype=np.float32), device=models.device)[None]
    if do_normalize is None:
        do_normalize = models.wav2vec_cfg.do_normalize
    if do_normalize:
        wav = normalize_waveform(wav)
    return wav2vec2_forward(models.wav2vec_params, models.wav2vec_cfg, wav)


def guidance_combine_long(noise_pred: torch.Tensor, text_scale: float, audio_scale: float):
    """Long-pipeline dual CFG over the [uncond, drop-audio, cond] batch."""
    uncond, drop_audio, cond = noise_pred.chunk(3, dim=0)
    return uncond + audio_scale * (drop_audio - uncond) + text_scale * (cond - drop_audio)
