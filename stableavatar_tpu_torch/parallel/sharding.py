"""Parameter sharding over the 'fsdp' mesh axis (port of
`stableavatar_tpu/parallel/sharding.py`).

The rule is the JAX package's: a parameter of at least 2^16 elements is
split on its largest axis that the fsdp size divides; smaller ones (norm
scales, biases, modulations, W8A8 weight scales) are replicated.
`shard_params` keeps this rank's slice of every such leaf -- the W8A8 int8
weights included -- as a `Shard`.  Where GSPMD all-gathers the shards of
the JAX package's sharded tree just in time, the port gathers them
explicitly: `gather_block` runs one all-gather per leaf on the fsdp group
just before a block runs, and the full tensors are dropped after it
(`models/dit.py`).  Sharded and unsharded runs compute from the same
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from stableavatar_tpu_torch.parallel.mesh import all_gather_dim0, axis_group, axis_rank, axis_size

# params smaller than this stay replicated (norm scales, biases, modulations)
_MIN_SHARD_SIZE = 2 ** 16


def param_sharding_spec(x, fsdp_size: int) -> Optional[int]:
    """The axis a leaf is split on over 'fsdp' (the largest one that
    fsdp_size divides), or None: replicated."""
    shape = tuple(x.shape)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < _MIN_SHARD_SIZE or fsdp_size <= 1:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % fsdp_size == 0:
            return ax
    return None


@dataclasses.dataclass
class Shard:
    """This rank's slice of a parameter split on `axis` over 'fsdp', kept
    with that axis first and contiguous (so the gather is one collective
    along dim 0)."""

    local: torch.Tensor
    axis: int
    shape: Tuple[int, ...]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def shard_params(params, mesh):
    """Keep this rank's 'fsdp' slice of every leaf that the rule splits;
    the full tensors are not referenced by the result."""
    fsdp, r = axis_size("fsdp", mesh), axis_rank("fsdp", mesh)

    def place(x):
        if not torch.is_tensor(x):
            return x
        ax = param_sharding_spec(x, fsdp)
        if ax is None:
            return x
        part = x.movedim(ax, 0).chunk(fsdp, dim=0)[r]
        return Shard(part.contiguous().clone(), ax, tuple(x.shape))

    return _tree_map(place, params)


def gather_block(params, mesh=None):
    """Full tensors for every `Shard` of a parameter (sub)tree -- one DiT
    block just before it runs, or the parameters outside the blocks --
    gathered over the fsdp group of `mesh` (the active mesh by default);
    other leaves pass through, and without a Shard no collective runs."""
    group = None

    def gather(x):
        nonlocal group
        if not isinstance(x, Shard):
            return x
        if group is None:
            group = axis_group("fsdp", mesh)
            if group is None:
                raise RuntimeError("gathering sharded parameters needs an active mesh")
        full = all_gather_dim0(x.local, group)
        return full if x.axis == 0 else full.movedim(0, x.axis).contiguous()

    return _tree_map(gather, params)


def replicate(tree, mesh=None):
    """Identity: eager tensors are already whole on every rank."""
    return tree
