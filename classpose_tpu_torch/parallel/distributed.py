"""Process-group helpers the trainer calls (counterpart of
``classpose_tpu/parallel/distributed.py``).

They use ``torch.distributed`` when a process group is initialised and
are trivial at world size 1. This slice trains on one card:
:func:`setup_distributed` raises for ``WORLD_SIZE > 1`` (multi-card data
parallelism is a later slice, see ``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class DistributedContext:
    distributed: bool
    rank: int
    local_rank: int
    world_size: int
    device: torch.device


def setup_distributed(device: str | torch.device = "cuda"
                      ) -> DistributedContext:
    """The run's context on one process. ``WORLD_SIZE`` > 1 raises."""
    world = int(os.getenv("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            "multi-card training (WORLD_SIZE > 1) is not ported yet; see "
            "ROADMAP.md queue 1")
    return DistributedContext(distributed=False, rank=get_rank(),
                              local_rank=0, world_size=get_world_size(),
                              device=torch.device(device))


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if _initialised() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialised() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def all_reduce_sum(x: np.ndarray) -> np.ndarray:
    """Sum of a host array over the processes."""
    if get_world_size() == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.asarray(x, np.float64))
    dist.all_reduce(t)
    return t.numpy()


def allgather_object(obj) -> list:
    """One python object per process, ordered by rank."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point."""
    if get_world_size() > 1:
        dist.barrier()
