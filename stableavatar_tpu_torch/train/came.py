"""CAME optimizer (Confidence-guided Adaptive Memory Efficient optimization,
Luo et al. 2023), port of `stableavatar_tpu/train/came.py`.

1. a factored (row / column) second moment of g^2 normalises the gradient:
   u = g / sqrt(v);
2. u is RMS-clipped, then m = EMA_b1(u);
3. the instability (u - m)^2 gets its own factored EMA (the confidence);
   the update is m / sqrt(confidence).

Parameters with fewer than 2 axes use an unfactored second moment and skip
the confidence step (as came_pytorch does).  Under fsdp the update sees
whole parameters (`optim.whole_leaves`): the row and column means, and the
RMS clip, are over the whole leaf.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stableavatar_tpu_torch.train.optim import GradientTransformation, whole_leaves


def _factored(shape) -> bool:
    return len(shape) >= 2


def _approx_sq_grad(row, col):
    """Rank-1 reconstruction of 1 / sqrt(v) from its row and column means."""
    r = row / row.mean(dim=-1, keepdim=True)
    return torch.rsqrt(r)[..., None] * torch.rsqrt(col)[..., None, :]


def came(learning_rate, betas: Tuple[float, float, float] = (0.9, 0.999, 0.9999),
         eps: Tuple[float, float] = (1e-30, 1e-16), weight_decay: float = 0.0,
         clip_threshold: float = 1.0) -> GradientTransformation:
    b1, b2, b3 = betas
    eps1, eps2 = eps

    def init(params):
        leaves = []
        for p in params:
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                leaves.append({
                    "exp_avg": torch.zeros(p.shape, **f32),
                    "row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                    "res_row": torch.zeros(p.shape[:-1], **f32),
                    "res_col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
                })
            else:
                zero = torch.zeros((), **f32)
                leaves.append({"exp_avg": torch.zeros(p.shape, **f32),
                               "row": torch.zeros(p.shape, **f32),
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
        for g, s, p in zip(grads, state["leaves"], params):
            g = g.float()
            sq = g * g + eps1
            if _factored(g.shape):
                row = b2 * s["row"] + (1 - b2) * sq.mean(dim=-1)
                col = b2 * s["col"] + (1 - b2) * sq.mean(dim=-2)
                u = g * _approx_sq_grad(row, col)
            else:
                row = b2 * s["row"] + (1 - b2) * sq
                col = s["col"]
                u = g * torch.rsqrt(row)
            rms = torch.sqrt((u * u).mean())
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            m = b1 * s["exp_avg"] + (1 - b1) * u
            if _factored(g.shape):
                res = (u - m) ** 2 + eps2
                res_row = b3 * s["res_row"] + (1 - b3) * res.mean(dim=-1)
                res_col = b3 * s["res_col"] + (1 - b3) * res.mean(dim=-2)
                upd = m * _approx_sq_grad(res_row, res_col)
            else:
                res_row, res_col = s["res_row"], s["res_col"]
                upd = m
            if weight_decay:
                upd = upd + weight_decay * p.float()
            deltas.append((-lr * upd).to(p.dtype))
            leaves.append({"exp_avg": m, "row": row, "col": col, "res_row": res_row,
                           "res_col": res_col})
        return deltas, {"count": state["count"] + 1, "leaves": leaves}

    # the parameters give the deltas their dtype (and the weight decay)
    return whole_leaves(GradientTransformation(init, update), with_params=True)
