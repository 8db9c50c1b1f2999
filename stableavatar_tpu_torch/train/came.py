"""CAME optimizer (Confidence-guided Adaptive Memory Efficient optimization,
Luo et al. 2023), port of `stableavatar_tpu/train/came.py`.

1. a factored (row / column) second moment of g^2 normalises the gradient:
   u = g / sqrt(v);
2. u is RMS-clipped, then m = EMA_b1(u);
3. the instability (u - m)^2 gets its own factored EMA (the confidence);
   the update is m / sqrt(confidence).

Parameters with fewer than 2 axes use an unfactored second moment and skip
the confidence step (as came_pytorch does).  Under fsdp each rank keeps
its slices (`optim.leaf_splits`): the first moment's, and those of the row
and column statistics whose mean the split does not cut.  A mean over the
split axis (the rows' under a split on the last axis, the columns' under a
split on the one before it) and the row statistics' normaliser over that
axis are summed over the fsdp group, so every rank holds the whole
statistic; the RMS clip's sum of squares is summed over the group too.
The sharded update equals the one-process update up to the order of those
fp32 sums.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stableavatar_tpu_torch.train.optim import GradientTransformation, Split, leaf_splits


def _factored(shape) -> bool:
    return len(shape) >= 2


def _approx_sq_grad(row, col, rows: Split):
    """Rank-1 reconstruction of 1 / sqrt(v) from its row and column means
    (views, the rows split as `rows`)."""
    r = row / rows.mean(row, -1, keepdim=True)
    return torch.rsqrt(r)[..., None] * torch.rsqrt(col)[..., None, :]


def came(learning_rate, betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
         eps: Tuple[float, float] = (1e-30, 1e-16), weight_decay: float = 0.0,
         clip_threshold: float = 1.0) -> GradientTransformation:
    b1, b2, b3 = betas
    eps1, eps2 = eps

    def init(params):
        leaves = []
        for p, split in zip(params, leaf_splits(params)):
            shape = split.view(p).shape
            f32 = dict(dtype=torch.float32, device=p.device)
            exp_avg = torch.zeros(p.shape, **f32)
            if _factored(shape):
                rows, cols = split.reduced(-1), split.reduced(-2)
                leaves.append({
                    "exp_avg": exp_avg,
                    "row": rows.local(torch.zeros(shape[:-1], **f32)),
                    "col": cols.local(torch.zeros(shape[:-2] + shape[-1:], **f32)),
                    "res_row": rows.local(torch.zeros(shape[:-1], **f32)),
                    "res_col": cols.local(torch.zeros(shape[:-2] + shape[-1:], **f32)),
                })
            else:
                zero = torch.zeros((), **f32)
                leaves.append({"exp_avg": exp_avg, "row": torch.zeros(p.shape, **f32),
                               "col": zero, "res_row": zero, "res_col": zero})
        device = params[0].device if len(params) else "cpu"
        return {"count": torch.zeros((), dtype=torch.int32, device=device), "leaves": leaves}

    def update(grads, state, params=None):
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        if params is None:
            if weight_decay:
                raise ValueError("came with weight_decay needs params")
            params = grads  # dtype source only
        deltas, leaves = [], []
        for g, s, p, split in zip(grads, state["leaves"], params, leaf_splits(grads)):
            g = split.view(g.float())
            sq = g * g + eps1
            if _factored(g.shape):
                rows, cols = split.reduced(-1), split.reduced(-2)
                row = b2 * rows.view(s["row"]) + (1 - b2) * split.mean(sq, -1)
                col = b2 * cols.view(s["col"]) + (1 - b2) * split.mean(sq, -2)
                u = g * _approx_sq_grad(row, col, rows)
            else:
                row = b2 * split.view(s["row"]) + (1 - b2) * sq
                col = s["col"]
                u = g * torch.rsqrt(row)
            rms = torch.sqrt(split.mean(u * u))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            m = b1 * split.view(s["exp_avg"]) + (1 - b1) * u
            if _factored(g.shape):
                res = (u - m) ** 2 + eps2
                res_row = b3 * rows.view(s["res_row"]) + (1 - b3) * split.mean(res, -1)
                res_col = b3 * cols.view(s["res_col"]) + (1 - b3) * split.mean(res, -2)
                upd = m * _approx_sq_grad(res_row, res_col, rows)
                stats = {"row": rows.local(row), "col": cols.local(col),
                         "res_row": rows.local(res_row), "res_col": cols.local(res_col)}
            else:
                upd = m
                stats = {"row": split.local(row), "col": col, "res_row": s["res_row"],
                         "res_col": s["res_col"]}
            if weight_decay:
                upd = upd + weight_decay * split.view(p.float())
            deltas.append(split.local((-lr * upd).to(p.dtype)))
            leaves.append({"exp_avg": split.local(m), **stats})
        return deltas, {"count": state["count"] + 1, "leaves": leaves}

    return GradientTransformation(init, update)
