"""Device lists for tile parallelism (counterpart of
``classpose_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a one-axis ``Mesh`` and lets
GSPMD partition one program over it. Here the devices stay an ordered
list, and parallelism is one replica of the network per listed device
(:func:`replicate`), each fed whole work items by its caller.
"""

from __future__ import annotations

import copy

import torch


def local_device_count() -> int:
    """Visible CUDA cards."""
    return torch.cuda.device_count()


def get_mesh(devices=None) -> list[torch.device]:
    """The ordered devices tile parallelism runs over: ``devices`` (torch
    devices or their names) or every visible card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(local_device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to run on")
    return devices


def replicate(net: torch.nn.Module, devices) -> list[torch.nn.Module]:
    """One copy of ``net`` per entry of ``devices``, in the same dtypes:
    ``net`` itself for the first entry when ``net`` lies there, else a
    deep copy moved onto the entry's device (so an entry repeated, two
    replicas on one card, gets a copy of its own). Copies share no
    parameter, buffer or attribute with ``net``."""
    devices = get_mesh(devices)
    home = next(net.parameters()).device
    out = []
    for i, dev in enumerate(devices):
        if i == 0 and dev == home:
            out.append(net)
            continue
        with torch.no_grad():
            out.append(copy.deepcopy(net).to(dev))
    return out
