"""Timestep embeddings (port of `stableavatar_tpu/ops/embeddings.py`)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_embedding_1d(dim: int, position: torch.Tensor) -> torch.Tensor:
    """[..., dim] fp32 sinusoidal embedding in [cos | sin] layout."""
    if dim % 2:
        raise ValueError(f"dim must be even, got {dim}")
    half = dim // 2
    pos = position.float()
    # computed in float64 and rounded once: bit-equal to the JAX package's
    # fp32 table (a fp32 pow differs in the last bit on a few entries)
    freqs = torch.as_tensor(np.exp(-np.log(10000.0) * np.arange(half) / half),
                            dtype=torch.float32, device=pos.device)
    sinusoid = pos[..., None] * freqs
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=-1)
