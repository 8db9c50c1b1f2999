"""Multi-process start-up (port of `stableavatar_tpu/parallel/distributed.py`).

One process per card.  `initialize_distributed` starts the default
`torch.distributed` process group -- NCCL on the card, gloo on the CPU --
from the CLI flags (`--coordinator_address host:port`, `--num_processes`,
`--process_id`) or, where a flag is missing, from torchrun's environment
(`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`):

    torchrun --nproc_per_node 4 -m stableavatar_tpu_torch.cli.inference \\
        --ulysses_degree 4 ...

Rank r drives `cuda:LOCAL_RANK` (LOCAL_RANK defaults to the rank).  With no
coordinator it does nothing and returns False, as the JAX function does.
The JAX package's `apply_platform_override` (a workaround for a JAX
platform pinned before the environment is read) has no counterpart here:
the port's device is an argument of its entry points.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from stableavatar_tpu_torch.parallel.mesh import axis_rank, axis_size, make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda") -> bool:
    """Start the default process group when multi-process information is
    present; returns True if it did (or one was already running)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs the number of processes and this "
                         "process's id (--num_processes, --process_id or torchrun's env)")
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): CUDA is not available; "
                               "pass device='cpu' for a gloo group on the host")
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_multihost_mesh(dp: Optional[int] = None, fsdp: int = 1, sp: int = 1,
                        device_type: str = "cuda"):
    """('dp', 'fsdp', 'sp') mesh over every rank: `dp=None` takes
    world // (fsdp * sp).  Ranks are numbered host by host (torchrun's
    order), so consecutive fsdp / sp groups stay within a host."""
    world = dist.get_world_size()
    if dp is None:
        if world % (fsdp * sp):
            raise ValueError(f"{world} ranks are not a multiple of fsdp={fsdp} x sp={sp}")
        dp = world // (fsdp * sp)
    return make_mesh(dp=dp, fsdp=fsdp, sp=sp, device_type=device_type)


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a dp-sharded global batch."""
    if not dist.is_initialized():
        return slice(0, global_batch)
    pc, i = dist.get_world_size(), dist.get_rank()
    per = global_batch // pc
    return slice(i * per, (i + 1) * per)


def replica_rows(global_batch: int, mesh=None) -> Tuple[slice, float]:
    """This rank's rows of a global batch split over the 'dp' axis of `mesh`
    (the active mesh by default), and the share of the batch mean they
    carry (rows / batch).  A batch that dp does not divide is split as
    GSPMD splits the JAX package's padded batch: ceil(batch / dp) rows a
    replica, the last ones shorter.  A replica left without a row takes the
    last row with share 0, so its ranks run the step's collectives and add
    nothing."""
    dp, d = axis_size("dp", mesh), axis_rank("dp", mesh)
    per = -(-global_batch // dp)
    start, stop = min(d * per, global_batch), min((d + 1) * per, global_batch)
    if start == stop:
        return slice(global_batch - 1, global_batch), 0.0
    return slice(start, stop), (stop - start) / global_batch
