"""Process-group helpers of data-parallel training (counterpart of
``classpose_tpu/parallel/distributed.py``).

One process per rank, as ``torchrun --nproc_per_node N`` starts them:
:func:`setup_distributed` reads torchrun's ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` and joins the group
(NCCL on CUDA, gloo on the CPU; gloo on CUDA too when asked, so that
several ranks can share one card). The helpers are trivial at world size
1. Host values travel as float64; a gloo collective on a CUDA tensor is
staged through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 1800  # the reference's DDP timeout
# seconds a collective waits for the other ranks before it raises
TIMEOUT_ENV = "CLASSPOSE_DIST_TIMEOUT_S"


@dataclasses.dataclass
class DistributedContext:
    distributed: bool
    rank: int
    local_rank: int
    world_size: int
    device: torch.device
    backend: str | None = None


def setup_distributed(device: str | torch.device = "cuda",
                      backend: str | None = None) -> DistributedContext:
    """The run's context on this process; joins the process group when
    ``WORLD_SIZE`` > 1.

    ``device``: a ``torch.device`` is this rank's device as it is (a
    caller may give several ranks one card, with ``backend="gloo"``); a
    ``--device`` string is parsed by ``utils.get_devices`` and this rank
    takes entry ``LOCAL_RANK`` of its list (``cuda``: every visible card,
    so rank r of a node takes ``cuda:r``; ``cpu``: every rank the CPU). A
    CUDA rank's device becomes its current device. ``backend`` defaults
    to NCCL on CUDA, gloo on the CPU. The group times out after ``CLASSPOSE_DIST_TIMEOUT_S`` seconds
    (default :data:`DEFAULT_TIMEOUT_S`)."""
    from classpose_tpu_torch.utils import get_devices

    world = int(os.getenv("WORLD_SIZE", "1"))
    rank = int(os.getenv("RANK", "0"))
    local_rank = int(os.getenv("LOCAL_RANK", str(rank)))
    if isinstance(device, torch.device):
        dev = device
    else:
        devs = get_devices(device)
        if devs[0].type == "cpu":
            devs = devs * (local_rank + 1)  # every rank on the one CPU
        if local_rank >= len(devs):
            raise ValueError(
                f"--device {device} lists {len(devs)} device(s); local rank "
                f"{local_rank} has none")
        dev = devs[local_rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1 and not _initialised():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        addr = os.getenv("MASTER_ADDR", "localhost")
        port = os.getenv("MASTER_PORT", "29500")
        timeout = float(os.getenv(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
        dist.init_process_group(
            backend, init_method=f"tcp://{addr}:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return DistributedContext(
        distributed=is_distributed(), rank=get_rank(), local_rank=local_rank,
        world_size=get_world_size(), device=dev,
        backend=dist.get_backend() if _initialised() else None)


def teardown_distributed() -> None:
    """Leave the process group, when this process joined one."""
    if _initialised():
        dist.destroy_process_group()


def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_distributed() -> bool:
    return get_world_size() > 1


def get_rank() -> int:
    return dist.get_rank() if _initialised() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialised() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def _backend_device(t: torch.Tensor) -> torch.device:
    """Where the group's backend takes ``t``: NCCL on the current card,
    gloo on the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a tensor on any device; returns ``t``."""
    if get_world_size() == 1:
        return t
    where = _backend_device(t)
    if t.device == where:
        dist.all_reduce(t, op=op)
    else:
        staged = t.to(where)
        dist.all_reduce(staged, op=op)
        t.copy_(staged)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """In-place broadcast of a tensor from rank ``src``; returns ``t``."""
    if get_world_size() == 1:
        return t
    where = _backend_device(t)
    if t.device == where:
        dist.broadcast(t, src)
    else:
        staged = t.to(where)
        dist.broadcast(staged, src)
        t.copy_(staged)
    return t


def all_reduce_sum(x: np.ndarray) -> np.ndarray:
    """Sum of a host array over the processes."""
    if get_world_size() == 1:
        return np.asarray(x)
    t = torch.as_tensor(np.asarray(x, np.float64)).clone()
    return all_reduce_(t).numpy()


def all_reduce_mean(x: np.ndarray) -> np.ndarray:
    """Mean of a host array over the processes."""
    return all_reduce_sum(x) / get_world_size()


def broadcast_object(obj, src: int = 0):
    """A python object of any size from rank ``src`` to every rank."""
    if get_world_size() == 1:
        return obj
    payload = pickle.dumps(obj) if get_rank() == src else b""
    n = torch.tensor([len(payload)], dtype=torch.int64)
    broadcast_(n, src)
    buf = torch.zeros(int(n), dtype=torch.uint8)
    if get_rank() == src:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    broadcast_(buf, src)
    return pickle.loads(buf.numpy().tobytes())


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
