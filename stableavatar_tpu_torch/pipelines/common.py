"""Shared pipeline machinery: model bundle, conditioning, CFG (port of
`stableavatar_tpu/pipelines/common.py`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from stableavatar_tpu_torch.config import (
    CLIPConfig,
    DiTConfig,
    T5Config,
    VAEConfig,
    Wav2Vec2Config,
)
from stableavatar_tpu_torch.models.clip import clip_visual_forward, preprocess_reference_image
from stableavatar_tpu_torch.models.t5 import t5_encode
from stableavatar_tpu_torch.models.vae import encode_video
from stableavatar_tpu_torch.models.wav2vec import normalize_waveform, wav2vec2_forward


@dataclasses.dataclass
class WanModels:
    """All parameter trees and configs of the generation stack, on `device`."""

    dit_params: Any
    dit_cfg: DiTConfig
    vae_params: Any
    vae_cfg: VAEConfig = VAEConfig()
    # umT5: on the models' device in bf16, or on the CPU in fp32 (--t5_cpu);
    # None once the loader has encoded the prompts and released it
    t5_params: Any = None
    t5_cfg: T5Config = T5Config()
    clip_params: Any = None
    clip_cfg: CLIPConfig = CLIPConfig()
    wav2vec_params: Any = None
    wav2vec_cfg: Wav2Vec2Config = Wav2Vec2Config()
    tokenizer: Optional[Callable] = None  # callable(str) -> (ids, mask) numpy arrays
    # inference fast path: dit_params prepared by utils/fastpath.py
    rope_split: bool = False
    attn_quant: str = "none"
    # sequence-parallel self-attention under an sp mesh: "ulysses" | "ring"
    attn_impl: str = "ulysses"
    # False reproduces the reference's SDPA deployment (vocal padding masks dropped)
    honor_vocal_k_lens: bool = True
    # the card unless the caller asks for the CPU (as the CPU tests do)
    device: Any = "cuda"
    teacache: Any = None  # optional models/teacache.py:TeaCache
    # pre-encoded CFG text context [3, text_len, text_dim], set when the
    # loader encoded the prompts and released T5 (t5_params is then None)
    text_ctx: Any = None
    # not ported yet; generate_long raises when it is set
    streamed_dit: Any = None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  A CUDA device on a host without
    CUDA raises: the port never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: CUDA is not available on this host; the port runs on "
            "the card unless the caller passes device='cpu'")
    return device


def _tree_device(tree) -> torch.device:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def encode_prompt_ids(models: WanModels, ids, mask) -> torch.Tensor:
    """T5-encode tokenised prompts [B, L] where the T5 parameters live (the
    models' device, or the CPU under --t5_cpu) and zero the padded
    positions; returns [B, text_len, text_dim] on the models' device.
    (The reference trims each row to its length and re-pads with zeros,
    which is the same at a fixed length.)"""
    t5_dev = _tree_device(models.t5_params)
    ids = torch.as_tensor(np.asarray(ids), device=t5_dev)
    mask = torch.as_tensor(np.asarray(mask), device=t5_dev)
    emb = t5_encode(models.t5_params, models.t5_cfg, ids, mask)
    emb = emb * mask[..., None].to(emb.dtype)
    return emb.to(resolve_device(models.device))


def stack_cfg_ids(tokenizer, prompt: str, negative_prompt: str = ""):
    """Tokenise into the long pipeline's CFG stack [neg, neg, pos]; returns
    numpy (ids, mask) [3, L]."""
    ids_p, mask_p = tokenizer(prompt)
    ids_n, mask_n = tokenizer(negative_prompt)
    return np.stack([ids_n, ids_n, ids_p]), np.stack([mask_n, mask_n, mask_p])


def encode_prompts(models: WanModels, prompt: str, negative_prompt: str = ""):
    """The CFG text context [3, text_len, text_dim]: [neg, neg, pos]."""
    if models.tokenizer is None or models.t5_params is None:
        raise ValueError("encode_prompts needs models.tokenizer and models.t5_params; "
                         "pass a pre-encoded text_ctx otherwise")
    ids, mask = stack_cfg_ids(models.tokenizer, prompt, negative_prompt)
    with torch.no_grad():
        return encode_prompt_ids(models, ids, mask)


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
