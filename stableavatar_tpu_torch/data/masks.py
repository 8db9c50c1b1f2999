"""Random inpaint-mask generation for training (numpy, host-side; copy of
`stableavatar_tpu/data/masks.py`, held equal by tests/test_torch_data.py).

Re-implements the 10 mask schemes of the reference `get_random_mask`
(`wan/dataset/talking_video_dataset_fantasy.py:16-99`) with vectorized numpy
(the reference's per-pixel Python loops for ellipse/circle are replaced by
coordinate grids).  Training uses `image_start_only=True` (first frame kept,
rest masked — `:321-325`); the full zoo is kept for inpaint-style variants.
"""

from __future__ import annotations

import numpy as np


def get_random_mask(
    shape, image_start_only: bool = False, rng: np.random.Generator | None = None
) -> np.ndarray:
    """shape (f, c, h, w) -> mask [f, 1, h, w] uint8 (1 = masked/inpaint)."""
    f, c, h, w = shape
    rng = rng or np.random.default_rng()
    mask = np.zeros((f, 1, h, w), dtype=np.uint8)

    if image_start_only:
        if f != 1:
            mask[1:] = 1
        else:
            mask[:] = 1
        return mask

    if f != 1:
        idx = rng.choice(10, p=[0.05, 0.2, 0.2, 0.2, 0.05, 0.05, 0.05, 0.1, 0.05, 0.05])
    else:
        idx = rng.choice(2, p=[0.2, 0.8])

    def rand_block():
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        bw = rng.integers(w // 4, w // 4 * 3)
        bh = rng.integers(h // 4, h // 4 * 3)
        return (
            max(cy - bh // 2, 0), min(cy + bh // 2, h),
            max(cx - bw // 2, 0), min(cx + bw // 2, w),
        )

    yy, xx = np.mgrid[0:h, 0:w]

    if idx == 0:
        y0, y1, x0, x1 = rand_block()
        mask[:, :, y0:y1, x0:x1] = 1
    elif idx == 1:
        mask[:] = 1
    elif idx == 2:
        mask[rng.integers(1, 5):] = 1
    elif idx == 3:
        k = int(rng.integers(1, 5))
        mask[k:-k] = 1
    elif idx == 4:
        y0, y1, x0, x1 = rand_block()
        fb = rng.integers(0, f // 2)
        fa = rng.integers(f // 2, f)
        mask[fb:fa, :, y0:y1, x0:x1] = 1
    elif idx == 5:
        mask = rng.integers(0, 2, (f, 1, h, w)).astype(np.uint8)
    elif idx == 6:
        n = rng.integers(1, max(f // 2, 1) + 1)
        for i in rng.choice(f, size=n, replace=False):
            bh = rng.integers(1, h // 4 + 1)
            bw = rng.integers(1, w // 4 + 1)
            y0 = rng.integers(0, h - bh + 1)
            x0 = rng.integers(0, w - bw + 1)
            mask[i, 0, y0 : y0 + bh, x0 : x0 + bw] = 1
    elif idx == 7:
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        a = rng.integers(min(w, h) // 8, min(w, h) // 4)
        b = rng.integers(min(w, h) // 8, min(w, h) // 4)
        ellipse = ((yy - cy) ** 2) / max(b**2, 1) + ((xx - cx) ** 2) / max(a**2, 1) < 1
        mask[:, :, ellipse] = 1
    elif idx == 8:
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        r = rng.integers(min(w, h) // 8, min(w, h) // 4)
        circle = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
        mask[:, :, circle] = 1
    elif idx == 9:
        keep = rng.random(f) > 0.5
        mask[keep] = 1
    return mask
