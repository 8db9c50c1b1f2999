"""LAB-space colour matching of decoded frames to the reference image (copy
of `stableavatar_tpu/utils/color_correction.py`, held equal by
tests/test_torch_utils.py).

Re-implements the reference `match_and_blend_colors` without skimage:
RGB <-> LAB (D65, sRGB gamma) written directly in host-side numpy.
"""

from __future__ import annotations

import numpy as np


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.clip(c, 0, None) ** (1 / 2.4) - 0.055)


_M_RGB2XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], dtype=np.float64
)
_WHITE = np.array([0.95047, 1.0, 1.08883])


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """rgb [..., 3] in [0,1] -> lab [..., 3]."""
    lin = _srgb_to_linear(rgb.astype(np.float64))
    xyz = lin @ _M_RGB2XYZ.T
    xyz = xyz / _WHITE

    eps, kappa = 216 / 24389, 24389 / 27
    f = np.where(xyz > eps, np.cbrt(xyz), (kappa * xyz + 16) / 116)
    L = 116 * f[..., 1] - 16
    a = 500 * (f[..., 0] - f[..., 1])
    b = 200 * (f[..., 1] - f[..., 2])
    return np.stack([L, a, b], axis=-1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16) / 116
    fx = fy + a / 500
    fz = fy - b / 200

    eps, kappa = 216 / 24389, 24389 / 27

    def finv(f):
        f3 = f**3
        return np.where(f3 > eps, f3, (116 * f - 16) / kappa)

    xyz = np.stack([finv(fx), finv(fy), finv(fz)], axis=-1) * _WHITE
    lin = xyz @ np.linalg.inv(_M_RGB2XYZ).T
    return np.clip(_linear_to_srgb(lin), 0.0, 1.0)


def match_and_blend_colors(
    source_chunk: np.ndarray,  # [B, C, T, H, W] in [-1, 1]
    reference_image: np.ndarray,  # [B, C, 1, H, W] in [-1, 1]
    strength: float,
) -> np.ndarray:
    """Match per-channel LAB mean/std of the chunk to the reference image,
    blended by `strength` (reference `color_correction.py:6-108`)."""
    if strength == 0.0:
        return source_chunk
    if not 0.0 <= strength <= 1.0:
        raise ValueError(f"strength must be in [0, 1], got {strength}")

    src = (source_chunk.transpose(0, 2, 3, 4, 1) + 1.0) / 2.0  # [B,T,H,W,C]
    ref = (reference_image.transpose(0, 2, 3, 4, 1) + 1.0) / 2.0

    out = np.empty_like(src)
    for bi in range(src.shape[0]):
        ref_lab = rgb_to_lab(ref[bi, 0])
        ref_mean = ref_lab.reshape(-1, 3).mean(0)
        ref_std = ref_lab.reshape(-1, 3).std(0)
        for ti in range(src.shape[1]):
            lab = rgb_to_lab(src[bi, ti])
            mean = lab.reshape(-1, 3).mean(0)
            std = lab.reshape(-1, 3).std(0)
            matched = (lab - mean) / np.maximum(std, 1e-6) * ref_std + ref_mean
            blended = (1 - strength) * lab + strength * matched
            out[bi, ti] = lab_to_rgb(blended)

    return (out * 2.0 - 1.0).transpose(0, 4, 1, 2, 3).astype(source_chunk.dtype)
