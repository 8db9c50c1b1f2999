"""The ('dp', 'fsdp', 'sp') device mesh (port of
`stableavatar_tpu/parallel/mesh.py`).

One `torch.distributed` DeviceMesh over every rank of the process group,
with one sub-group per axis: 'dp' replicas, 'fsdp' parameter shards
(`parallel/sharding.py`), 'sp' sequence parallelism (Ulysses all-to-all or
the K/V ring, `models/dit.py`).  Rank r sits at (dp, fsdp, sp) in row-major
order, so the ranks of one sp group are consecutive.  NCCL on the card,
gloo on the CPU.  Where the JAX package compiles its collectives into the
program under GSPMD, the port issues them explicitly.

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


# the one-tensor all-gather (named all_gather_single in newer torch)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x [n, ...] of `group`, concatenated in rank order on dim
    0: [W * n, ...]."""
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, x, group=group)
    return out
