"""AdamW with an int8-quantised second moment, the `--use_8bit_adam`
analog (port of `stableavatar_tpu/train/adam8bit.py`).

The second moment nu is stored as int8 with one fp32 absmax scale per
last-axis row and dequantised inside the update; the first moment is bf16.
Under fsdp each rank keeps its slices of mu and of nu's codes
(`optim.leaf_splits`).  A split on any axis but the last leaves the rows
whole on the rank, and the scales are computed and sliced with them; a
split on the last axis cuts every row, whose absmax is then the max over
the fsdp group, and every rank holds all the scales.  A max is exact and
the rest is element by element, so the sharded update equals the
one-process update bit for bit.
"""

from __future__ import annotations

import torch

from stableavatar_tpu_torch.train.optim import (
    GradientTransformation,
    Split,
    add_decayed_weights,
    chain,
    leaf_splits,
    scale,
)


def _quantize(x: torch.Tensor, split: Split):
    """{"q": int8, "scale": fp32 [..., 1]} of this rank's slice `x` of a
    leaf split as `split`, each as its `Split` keeps it; round half to even
    like jnp.round."""
    v = split.view(x)
    amax = split.amax(v.abs(), -1, keepdim=True)
    s = torch.clamp(amax / 127.0, min=1e-20)
    q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
    return {"q": split.local(q), "scale": split.reduced(-1, keepdim=True).local(s.float())}


def _dequantize(s, split: Split) -> torch.Tensor:
    scales = split.reduced(-1, keepdim=True).view(s["scale"])
    return split.local(split.view(s["q"]).float() * scales)


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-10):
    def init(params):
        device = params[0].device if len(params) else "cpu"
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": [torch.zeros_like(p, dtype=torch.bfloat16) for p in params],
                "nu": [_quantize(torch.zeros_like(p, dtype=torch.float32), split)
                       for p, split in zip(params, leaf_splits(params))]}

    def update(updates, state, params=None):
        count = state["count"] + 1
        b1c = 1 - torch.tensor(b1, dtype=torch.float32, device=count.device) ** count.float()
        b2c = 1 - torch.tensor(b2, dtype=torch.float32, device=count.device) ** count.float()
        steps, mus, nus = [], [], []
        for g, mu, nu_q, split in zip(updates, state["mu"], state["nu"],
                                      leaf_splits(updates)):
            g = g.float()
            mu_f = mu.float() * b1 + g * (1 - b1)
            nu_f = _dequantize(nu_q, split) * b2 + g.square() * (1 - b2)
            steps.append((mu_f / b1c) / (torch.sqrt(nu_f / b2c) + eps))
            mus.append(mu_f.to(torch.bfloat16))
            nus.append(_quantize(nu_f, split))
        return steps, {"count": count, "mu": mus, "nu": nus}

    return GradientTransformation(init, update)


def adamw8bit(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-10,
              weight_decay: float = 3e-2) -> GradientTransformation:
    return chain(scale_by_adam8bit(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale(-learning_rate))
