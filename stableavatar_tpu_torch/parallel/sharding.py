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
numbers.  Under autograd the gather's backward is the summing
reduce-scatter (`parallel/mesh.py:all_gather_dim0`), so a shard's gradient
arrives on the rank that holds it and the optimizer state stays sharded
(ZeRO), as the JAX package's is under GSPMD.  Checkpoints hold full
tensors: `unshard` gathers a leaf, `shard_params` / `shard_like` split them
again.
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


def _local(x: torch.Tensor, ax: int, fsdp: int, r: int) -> torch.Tensor:
    return x.movedim(ax, 0).chunk(fsdp, dim=0)[r].contiguous().clone()


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
        return Shard(_local(x, ax, fsdp, r), ax, tuple(x.shape))

    return _tree_map(place, params)


def leaf_specs(tree) -> list:
    """Per leaf of a parameter tree (`utils/tree.py:tree_leaves` order): its
    Shard where the leaf is split over 'fsdp', else None."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaf_specs(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaf_specs(v)]
    return [tree if isinstance(tree, Shard) else None]


def shard_like(x: torch.Tensor, spec: Optional[Shard], mesh=None) -> torch.Tensor:
    """This rank's slice of a full tensor shaped like the parameter whose
    Shard is `spec` (an optimizer moment), or x itself where the parameter
    is replicated (spec None)."""
    if spec is None:
        return x
    return _local(x, spec.axis, axis_size("fsdp", mesh), axis_rank("fsdp", mesh))


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


def unshard(x, mesh=None, spec: Optional[Shard] = None):
    """The full tensor of a Shard -- or of a local tensor laid out like the
    Shard `spec` (an optimizer moment) -- gathered over the fsdp group of
    `mesh` (the active mesh by default); any other leaf as it is.  A
    collective: every rank of the fsdp group calls it."""
    if isinstance(x, Shard):
        x, spec = x.local, x
    if spec is None or not torch.is_tensor(x):
        return x
    full = all_gather_dim0(x.detach(), axis_group("fsdp", mesh))
    return full if spec.axis == 0 else full.movedim(0, spec.axis).contiguous()


def replicate(tree, mesh=None):
    """Identity: eager tensors are already whole on every rank."""
    return tree
