"""The ('dp', 'fsdp', 'sp') device mesh (port of
`stableavatar_tpu/parallel/mesh.py`).

One `torch.distributed` DeviceMesh over every rank of the process group,
with one sub-group per axis: 'dp' replicas, 'fsdp' parameter shards
(`parallel/sharding.py`), 'sp' sequence parallelism (Ulysses all-to-all or
the K/V ring, `models/dit.py`).  Rank r sits at (dp, fsdp, sp) in row-major
order, so the ranks of one sp group are consecutive.  NCCL on the card,
gloo on the CPU.  Where the JAX package compiles its collectives into the
program under GSPMD, the port issues them explicitly; under autograd the
all-gather and the all-to-all carry their gradients back (a summing
reduce-scatter, the inverse exchange).

The active mesh is a context variable, as in the JAX package: model code
reads `current_mesh()` and runs its sequence-parallel and sharded paths
only under `mesh_context(mesh)`.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "sp")

_MESH: contextvars.ContextVar = contextvars.ContextVar("stableavatar_torch_mesh", default=None)


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, device_type: str = "cuda"):
    """The ('dp', 'fsdp', 'sp') mesh over the initialised process group,
    whose world size must be dp * fsdp * sp (`parallel/distributed.py`
    starts it)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/distributed.py:initialize_distributed)")
    n, world = dp * fsdp * sp, dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh dp={dp} x fsdp={fsdp} x sp={sp} = {n} ranks, the process "
                         f"group has {world}")
    return init_device_mesh(device_type, (dp, fsdp, sp), mesh_dim_names=AXES)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate a mesh (or None) for the model code inside."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def axis_size(name: str, mesh=None) -> int:
    """Size of one mesh axis; 1 without an active mesh."""
    mesh = current_mesh() if mesh is None else mesh
    return 1 if mesh is None else mesh.size(AXES.index(name))


def axis_rank(name: str, mesh=None) -> int:
    """This rank's coordinate on one mesh axis; 0 without an active mesh."""
    mesh = current_mesh() if mesh is None else mesh
    return 0 if mesh is None else mesh.get_local_rank(name)


def axis_group(name: str, mesh=None) -> Optional[dist.ProcessGroup]:
    mesh = current_mesh() if mesh is None else mesh
    return None if mesh is None else mesh.get_group(name)


# the one-tensor all-gather and reduce-scatter (named *_single in newer torch)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x, group=group)
    return out


def _scatter_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of every rank's x [W * n, ...], rank r keeping
    rows [r n, (r+1) n)."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGatherDim0(torch.autograd.Function):
    """All-gather forward; its adjoint, the summing reduce-scatter, backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim0(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_dim0(grad, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` on equal dim-0 chunks; the exchange is its own
    adjoint (chunk j goes to rank j and its gradient comes back the same
    way), so the backward runs it again on the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x [n, ...] of `group`, concatenated in rank order on dim
    0: [W * n, ...].  Under autograd the gradient of each rank's x is the
    sum over the group of the gradients of its rows (reduce-scatter)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGatherDim0.apply(x, group)
    return _gather_dim0(x, group)


def all_to_all_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's dim 0 (W equal chunks) to rank j; rank j's chunk r
    comes back as chunk j.  Differentiable (the inverse exchange)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group)
    return _exchange(x, group)


# elements of one bucket of all_reduce_coalesced (128 MB of bf16)
_BUCKET_ELEMS = 1 << 26


def all_reduce_coalesced(tensors, group) -> None:
    """Sum each tensor over `group` in place, packed into flat buckets of one
    dtype and at most _BUCKET_ELEMS elements (one collective a bucket, not
    one a tensor)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        start = 0
        while start < len(ts):
            stop, size = start + 1, ts[start].numel()
            while stop < len(ts) and size + ts[stop].numel() <= _BUCKET_ELEMS:
                size += ts[stop].numel()
                stop += 1
            bucket = ts[start:stop]
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            start = stop
