"""LoRA as parallel parameter trees: create / merge / unmerge / save / load
(port of `stableavatar_tpu/utils/lora.py`).

Adapters are a tree beside the DiT's: a {"down", "up"} pair at every
target leaf, None elsewhere.  `merge_lora` folds them into the weights for
deployment, `unmerge_lora` subtracts them back.  The policy is the JAX
package's: kaiming-uniform down / zero up, the vocal and audio modules
skipped, scale alpha / rank.  The factors have the JAX package's shapes,
down [d_in, rank] and up [rank, d_out] (a leading layer axis on stacked
[L, ., .] weights), so adapters move between the two packages through
numpy; the port's linear weights are in nn.Linear layout [d_out, d_in]
(stacked [L, d_out, d_in]), so the delta is added transposed.

A target is a linear weight inside the blocks: a "w" leaf of 2 or 3 axes.
The JAX rule reads the stacked norm scales [L, dim] as 2-D targets too; the
port's per-block norm scales have one axis and are not targets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stableavatar_tpu_torch.utils.tree import tree_leaves


def _is_target(path: str, leaf, include_vocal: bool) -> bool:
    if not path.endswith("w") or not torch.is_tensor(leaf) or leaf.ndim not in (2, 3):
        return False
    if "blocks" not in path:
        return False
    return include_vocal or ("vocal" not in path and "audio" not in path)


def _map(fn, tree, path: str = ""):
    """fn(path, leaf) over a parameter tree, paths joined with "/"."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}/{i}") for i, v in enumerate(tree))
    return fn(path.lstrip("/"), tree)


def _is_pair(x) -> bool:
    return isinstance(x, dict) and "down" in x


def _pairs(lora, path: str = ""):
    """(path, {"down", "up"}) of every adapter in a lora tree."""
    if _is_pair(lora):
        return [(path.lstrip("/"), lora)]
    if isinstance(lora, dict):
        return [x for k, v in lora.items() for x in _pairs(v, f"{path}/{k}")]
    if isinstance(lora, (list, tuple)):
        return [x for i, v in enumerate(lora) for x in _pairs(v, f"{path}/{i}")]
    return []


def create_lora(generator: torch.Generator, params, rank: int = 128, alpha: float = 64.0,
                include_vocal: bool = False):
    """A lora tree: {down, up} at every target leaf (drawn in tree order
    from `generator`, fp32 on the leaf's device), None elsewhere; rank and
    alpha are carried by the caller."""

    def make(path, leaf):
        if not _is_target(path, leaf, include_vocal):
            return None
        *lead, d_out, d_in = leaf.shape
        lim = math.sqrt(3.0) * math.sqrt(2.0) / math.sqrt(d_in)  # kaiming, a = sqrt(5)
        down = torch.rand((*lead, d_in, rank), generator=generator, device=leaf.device)
        return {"down": down * (2 * lim) - lim,
                "up": torch.zeros((*lead, rank, d_out), device=leaf.device)}

    return _map(make, params)


def lora_delta(lora_leaf, rank: int, alpha: float, multiplier: float = 1.0) -> torch.Tensor:
    """The weight delta in the JAX layout [.., d_in, d_out]."""
    scale = multiplier * alpha / rank
    return (lora_leaf["down"] @ lora_leaf["up"]) * scale


def merge_lora(params, lora, rank: int, alpha: float, multiplier: float = 1.0):
    """Fold the adapters into the weights (in fp32, rounded to each
    weight's dtype); a new tree, the other leaves shared."""
    pairs = dict(_pairs(lora))

    def merge(path, p):
        pair = pairs.get(path)
        if pair is None:
            return p
        delta = lora_delta(pair, rank, alpha, multiplier).transpose(-1, -2)
        return (p.float() + delta.to(p.device)).to(p.dtype)

    return _map(merge, params)


def unmerge_lora(params, lora, rank: int, alpha: float, multiplier: float = 1.0):
    return merge_lora(params, lora, rank, alpha, -multiplier)


def lora_trainable_mask(params, lora):
    """Trainable flags (`train/trainer.py:make_optimizer` masks): every
    parameter leaf frozen, every lora factor trained."""
    return ([False] * len(tree_leaves(params)),
            [True] * sum(2 for _ in _pairs(lora)))


def save_lora(path: str, lora, rank: int, alpha: float) -> None:
    """An .npz of "<leaf path>/down" and "/up" arrays with the rank and alpha."""
    flat = {}
    for name, pair in _pairs(lora):
        flat[f"{name}/down"] = pair["down"].detach().cpu().numpy()
        flat[f"{name}/up"] = pair["up"].detach().cpu().numpy()
    flat["__rank__"] = np.asarray(rank)
    flat["__alpha__"] = np.asarray(alpha)
    np.savez(path, **flat)


def load_lora(path: str, params, include_vocal: bool = False):
    """(lora, rank, alpha) from `save_lora`'s file, on the devices of
    `params`' leaves."""
    data = np.load(path)
    rank, alpha = int(data["__rank__"]), float(data["__alpha__"])

    def rebuild(name, leaf):
        if not _is_target(name, leaf, include_vocal) or f"{name}/down" not in data:
            return None
        return {"down": torch.as_tensor(data[f"{name}/down"], device=leaf.device),
                "up": torch.as_tensor(data[f"{name}/up"], device=leaf.device)}

    return _map(rebuild, params), rank, alpha
