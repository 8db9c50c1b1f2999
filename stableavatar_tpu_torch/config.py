"""Model configurations of the port.

Field-for-field copies of the frozen dataclasses in
`stableavatar_tpu/config.py` (the DiT, VAE, umT5, CLIP and wav2vec2
configs, the scheduler config, `WAN_1_3B`, `WAN_14B` and
`tiny_debug_configs`), kept here so that the port, and a run of it on the card, loads
nothing of the JAX package.  `tests/test_torch_package.py` holds the two
definitions equal field by field.  The port's functions read configs by
attribute only, so the JAX package's config objects work there too (the
parity tests pass them).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Wan2.1 DiT backbone (1.3B defaults)."""

    model_type: str = "i2v"
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 36
    dim: int = 1536
    ffn_dim: int = 8960
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 12
    num_layers: int = 30
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    clip_tokens: int = 257
    clip_dim: int = 1280
    rope_max_seq: int = 1024
    riflex_k: Optional[int] = None
    riflex_L_test: Optional[int] = None
    riflex_scale: Optional[float] = None
    audio_in_dim: int = 768
    audio_proj_dim: int = 1536
    audio_proj_hidden: Optional[int] = None
    vocal_num_layers: int = 2
    vocal_num_heads: int = 8

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B = DiTConfig()

# 14B: dim 5120 / ffn 13824 / 40 heads / 40 layers, two-stage 768 -> 2048 ->
# 5120 vocal projection
WAN_14B = DiTConfig(
    dim=5120,
    ffn_dim=13824,
    num_heads=40,
    num_layers=40,
    audio_proj_dim=5120,
    audio_proj_hidden=2048,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE (Wan2.1_VAE)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    latent_mean: Tuple[float, ...] = (
        -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
        0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
    )
    latent_std: Tuple[float, ...] = (
        2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
        3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
    )


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-xxl encoder."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False
    text_len: int = 512
    eps: float = 1e-6
    max_dist: int = 128


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """CLIP ViT-H/14 visual tower."""

    embed_dim: int = 1024
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1280
    vision_heads: int = 16
    vision_layers: int = 32
    mlp_ratio: int = 4
    eps: float = 1e-5
    image_mean: Tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """wav2vec2-base-960h."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_normalize: bool = True
    eps: float = 1e-5

    def output_length(self, num_samples: int) -> int:
        n = num_samples
        for k, s in zip(self.conv_kernels, self.conv_strides):
            n = (n - k) // s + 1
        return n



@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """FlowMatch Euler scheduler config (the YAML's `scheduler_kwargs`)."""

    num_train_timesteps: int = 1000
    shift: float = 5.0
    use_dynamic_shifting: bool = False
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096

def tiny_debug_configs():
    """Miniature (DiT, VAE, T5, CLIP, wav2vec2) configs for checkpoint-free
    smoke runs (`STABLEAVATAR_TINY=1` in the inference CLI): a few layers of
    width ~32 each, random weights, plumbing only."""
    dit = DiTConfig(
        dim=32, ffn_dim=64, freq_dim=16, text_dim=32,
        in_dim=12,  # z(4) + mask(4) + masked latents(4)
        out_dim=4, num_heads=4, num_layers=2, text_len=16,
        clip_tokens=5, clip_dim=32, audio_in_dim=16, audio_proj_dim=32,
        vocal_num_heads=4,
    )
    vae = VAEConfig(
        dim=4, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1,
        temporal_downsample=(True, True), temporal_compression_ratio=4,
        spatial_compression_ratio=4,
        latent_mean=(0.0,) * 4, latent_std=(1.0,) * 4,
    )
    t5 = T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=64, num_heads=4,
                  num_layers=2, text_len=16)
    clip = CLIPConfig(image_size=28, patch_size=14, vision_dim=32,
                      vision_heads=2, vision_layers=2)
    w2v = Wav2Vec2Config(hidden_size=16, num_layers=2, num_heads=2,
                         ffn_dim=32, conv_dims=(8,) * 7,
                         num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4)
    return dit, vae, t5, clip, w2v
