"""3D rotary position embedding for the Wan DiT (port of
`stableavatar_tpu/ops/rope.py`).

The cos/sin tables are built in float64 with numpy, as in the JAX package,
and stored as fp32 tensors.  `rope_apply` rotates interleaved pairs
(2j, 2j+1); the split-pair layout (pair j at channels j and j + d/2) is the
fast-path form, reached by permuting the q/k projection weights once
(`split_pair_permutation`).  All outputs are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class RopeFreqs:
    """Per-grid cos/sin tables, shape [F*H*W, head_dim//2] each, fp32."""

    cos: torch.Tensor
    sin: torch.Tensor


def _axis_freqs(
    dim_half: int,
    theta: float = 10000.0,
    riflex_k: Optional[int] = None,
    riflex_L_test: Optional[int] = None,
    riflex_scale: Optional[float] = None,
) -> np.ndarray:
    """Inverse frequencies of one axis; RIFLEx replaces the k-th one."""
    freqs = 1.0 / np.power(
        theta, np.arange(0, 2 * dim_half, 2, dtype=np.float64) / (2 * dim_half)
    )
    if riflex_k is not None:
        freqs[riflex_k - 1] = 0.9 * 2 * np.pi / riflex_L_test
        if riflex_scale is not None:
            freqs[riflex_k - 1] = freqs[riflex_k - 1] / riflex_scale
    return freqs


def rope_freqs_3d(
    grid: Tuple[int, int, int],
    head_dim: int,
    theta: float = 10000.0,
    riflex_k: Optional[int] = None,
    riflex_L_test: Optional[int] = None,
    riflex_scale: Optional[float] = None,
    device=None,
) -> RopeFreqs:
    """Flattened [F*H*W, head_dim//2] cos/sin tables of a 3D grid; the head
    dim is split (d - 4(d//6), 2(d//6), 2(d//6)) over (frames, height,
    width)."""
    f, h, w = grid
    c = head_dim // 2
    c_h = c // 3
    c_w = c // 3
    c_f = c - 2 * (c // 3)

    def table(n, dim_half, **kw):
        return np.outer(np.arange(n, dtype=np.float64), _axis_freqs(dim_half, theta, **kw))

    ang_f = table(f, c_f, riflex_k=riflex_k, riflex_L_test=riflex_L_test,
                  riflex_scale=riflex_scale)
    ang_h = table(h, c_h)
    ang_w = table(w, c_w)
    ang = np.concatenate(
        [
            np.broadcast_to(ang_f[:, None, None, :], (f, h, w, c_f)),
            np.broadcast_to(ang_h[None, :, None, :], (f, h, w, c_h)),
            np.broadcast_to(ang_w[None, None, :, :], (f, h, w, c_w)),
        ],
        axis=-1,
    ).reshape(f * h * w, c)
    return RopeFreqs(
        cos=torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
        sin=torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device),
    )


def rope_apply(x: torch.Tensor, freqs: RopeFreqs) -> torch.Tensor:
    """Rotate interleaved pairs of x [B, L, N, D]; returns fp32."""
    b, l, n, d = x.shape
    xf = x.float().reshape(b, l, n, d // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    cos = freqs.cos[None, :, None, :]
    sin = freqs.sin[None, :, None, :]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(b, l, n, d)


def split_pair_permutation(head_dim: int, num_heads: int) -> np.ndarray:
    """Channel permutation (new[c] = old[perm[c]]) over num_heads*head_dim
    channels moving interleaved rope pairs to the split layout."""
    half = head_dim // 2
    per_head = np.concatenate([np.arange(half) * 2, np.arange(half) * 2 + 1])
    return np.concatenate([h * head_dim + per_head for h in range(num_heads)])


def pack_split(freqs: RopeFreqs) -> torch.Tensor:
    """[L, head_dim] fp32 table: cos || sin."""
    return torch.cat([freqs.cos, freqs.sin], dim=1)


def rope_apply_split(x: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Rope on x [B, L, N, D] in split-pair layout; returns fp32."""
    half = x.shape[-1] // 2
    xf = x.float()
    x0, x1 = xf[..., :half], xf[..., half:]
    c = packed[None, :, None, :half]
    s = packed[None, :, None, half:]
    return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)


def rope_apply_split_inv(g: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Inverse (transpose) of `rope_apply_split` on g [B, L, N, D]: the
    gradient of the rotation with respect to its input (JAX
    `ops/flash_attention.py:_rot_inv`); returns fp32."""
    half = g.shape[-1] // 2
    gf = g.float()
    g0, g1 = gf[..., :half], gf[..., half:]
    c = packed[None, :, None, :half]
    s = packed[None, :, None, half:]
    return torch.cat([g0 * c + g1 * s, -g0 * s + g1 * c], dim=-1)
