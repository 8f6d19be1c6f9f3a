"""Masked heat diffusion for the flow-error QC (CUDA kernel + plain
PyTorch version).

Counterpart of ``classpose_tpu/ops/diffusion_pallas.py``
``diffuse_resident_pallas`` as the fused QC uses it: a batch of tiles,
each with its own iteration count. The CUDA design (``csrc/diffusion.cu``)
packs the loop-invariant neighbour matches once, then launches one
stencil per iteration up to the batch's largest count.

A wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from classpose_tpu_torch import _build

# XLA rewrites the division by 9 in the JAX stencil into a multiply by
# float32(1/9); the port multiplies by the same constant to stay bitwise
NINTH = torch.tensor(1.0 / 9.0, dtype=torch.float32)

SHIFTS9 = [
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 0), (0, 1),
    (1, -1), (1, 0), (1, 1),
]


def masked_diffusion_plain(ids: torch.Tensor, center: torch.Tensor,
                           niter: torch.Tensor) -> torch.Tensor:
    """``_diffuse_dyn`` over a batch: tile b runs ``niter[b]`` iterations
    of ``T ← where(ids>0, Σ_{same-id 3×3 nbrs}(T + cen)·(1/9), 0)``."""
    B, H, W = ids.shape
    ids_p = F.pad(ids, (1, 1, 1, 1))
    fg = ids > 0
    cen = center * fg
    ninth = NINTH.to(ids.device)
    T = torch.zeros((B, H, W), dtype=torch.float32, device=ids.device)
    nmax = int(niter.max()) if niter.numel() else 0
    for it in range(nmax):
        Tp = F.pad(T + cen, (1, 1, 1, 1))
        acc = torch.zeros_like(T)
        for dy, dx in SHIFTS9:
            nb_T = Tp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            nb_id = ids_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            acc = acc + torch.where(nb_id == ids, nb_T, 0.0)
        new = torch.where(fg, acc * ninth, 0.0)
        T = torch.where((it < niter)[:, None, None], new, T)
    return T


def masked_diffusion(ids: torch.Tensor, center: torch.Tensor,
                     niter: torch.Tensor) -> torch.Tensor:
    """ids (B, H, W) int32, center (B, H, W) f32, niter (B,) int32 →
    T (B, H, W) f32, bit-identical to the plain version."""
    B, H, W = ids.shape
    dev = ids.device
    if ids.dtype != torch.int32 or center.dtype != torch.float32 \
            or niter.dtype != torch.int32:
        raise TypeError(f"dtypes {ids.dtype}, {center.dtype}, {niter.dtype}")
    if center.shape != ids.shape or niter.shape != (B,):
        raise ValueError(f"shapes {ids.shape}, {center.shape}, {niter.shape}")
    for t in (ids, center, niter):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on one device")
    if dev.type == "cpu":
        return masked_diffusion_plain(ids, center, niter)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _build.lib("diffusion")
    stream = _build.stream_ptr(dev)
    cenm = torch.empty_like(center)
    mask = torch.empty((B, H, W), dtype=torch.int16, device=dev)
    _build.check(
        lib.diffusion_pack_nbr(ids.data_ptr(), center.data_ptr(),
                               cenm.data_ptr(), mask.data_ptr(), B, H, W,
                               stream),
        "diffusion_pack_nbr",
    )
    _build.count("masked_diffusion")
    nmax = int(niter.max()) if B else 0
    T = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    if nmax == 0:
        return T
    T2 = torch.empty_like(T)
    for it in range(nmax):
        _build.check(
            lib.diffusion_step(T.data_ptr(), T2.data_ptr(), cenm.data_ptr(),
                               mask.data_ptr(), niter.data_ptr(), B, H, W,
                               it, stream),
            "diffusion_step",
        )
        _build.count("masked_diffusion")
        T, T2 = T2, T
    return T
