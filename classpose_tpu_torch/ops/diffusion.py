"""Masked heat diffusion for the flow-error QC and the flow targets (CUDA
kernels + plain PyTorch versions).

Two counterparts of ``classpose_tpu/ops/diffusion_pallas.py``:

- :func:`masked_diffusion` (kernel 4, ``csrc/diffusion.cu``):
  ``diffuse_resident_pallas`` as the fused QC uses it, a batch of tiles
  from zero, each with its own iteration count. It packs the
  loop-invariant neighbour matches once, then each launch runs up to 16
  iterations of a 128² window (96² interior, 16-pixel halo) in shared
  memory, up to the batch's largest count.
- :func:`diffuse_blocked` (kernel 7, ``csrc/diffusion_blocked.cu``):
  ``diffuse_pallas``, the same stencil from a start field ``T0``, with
  each tile's count rounded up to a multiple of ``k``. One launch runs
  up to 8 iterations of a 64² block in shared memory with an 8-pixel
  halo.

``resident_diffusion_supported`` is the JAX package's gate between the
two designs; ``dynamics/flows.py`` routes by it.

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


# the JAX package's residency gate of diffuse_resident_pallas: ~15 f32
# (H, W) planes in 100 MiB of VMEM, H a multiple of 8, W of 128
_RESIDENT_PLANES = 15
_RESIDENT_VMEM_LIMIT = 100 * 1024 * 1024


def resident_diffusion_supported(H: int, W: int) -> bool:
    """True for the geometries the JAX package diffuses with its resident
    kernel (kernel 4's route in the port); the others take the blocked
    design (kernel 7)."""
    return (H % 8 == 0 and W % 128 == 0
            and _RESIDENT_PLANES * H * W * 4 <= _RESIDENT_VMEM_LIMIT)


def _diffuse_plain(T0: torch.Tensor, ids: torch.Tensor,
                   center: torch.Tensor, niter: torch.Tensor
                   ) -> torch.Tensor:
    """From ``T0``, tile b runs ``niter[b]`` iterations of
    ``T ← where(ids>0, Σ_{same-id 3×3 nbrs}(T + cen)·(1/9), 0)``."""
    B, H, W = ids.shape
    ids_p = F.pad(ids, (1, 1, 1, 1))
    fg = ids > 0
    cen = center * fg
    ninth = NINTH.to(ids.device)
    T = T0
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


def masked_diffusion_plain(ids: torch.Tensor, center: torch.Tensor,
                           niter: torch.Tensor) -> torch.Tensor:
    """``_diffuse_dyn`` over a batch: tile b runs ``niter[b]`` iterations
    from zero."""
    T0 = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    return _diffuse_plain(T0, ids, center, niter)


def _check_inputs(ids, center, niter, *fields):
    B = ids.shape[0]
    if ids.dtype != torch.int32 or niter.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (center, *fields)):
        raise TypeError(f"dtypes {ids.dtype}, {center.dtype}, {niter.dtype}")
    if ids.ndim != 3 or niter.shape != (B,) or any(
            t.shape != ids.shape for t in (center, *fields)):
        raise ValueError(f"shapes {ids.shape}, {center.shape}, {niter.shape}")
    for t in (ids, center, niter, *fields):
        if t.device != ids.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous on one device")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {ids.device}")


def masked_diffusion(ids: torch.Tensor, center: torch.Tensor,
                     niter: torch.Tensor) -> torch.Tensor:
    """ids (B, H, W) int32, center (B, H, W) f32, niter (B,) int32 →
    T (B, H, W) f32, bit-identical to the plain version."""
    B, H, W = ids.shape
    dev = ids.device
    _check_inputs(ids, center, niter)
    if dev.type == "cpu":
        return masked_diffusion_plain(ids, center, niter)
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
    if nmax <= 0:
        return T
    depth = lib.diffusion_resident_depth()
    T2 = torch.empty_like(T)
    for s0 in range(0, nmax, depth):
        _build.check(
            lib.diffusion_resident_round(
                T.data_ptr(), T2.data_ptr(), cenm.data_ptr(),
                mask.data_ptr(), niter.data_ptr(), B, H, W, s0, stream),
            "diffusion_resident_round",
        )
        _build.count("masked_diffusion")
        T, T2 = T2, T
    return T


def _rounded_counts(niters: torch.Tensor, k: int) -> torch.Tensor:
    """``ceil(niters/k)·k``: the TPU kernel reads its per-tile active flag
    once per round of ``k`` iterations."""
    return (niters + (k - 1)) // k * k


def diffuse_blocked_plain(T0: torch.Tensor, ids: torch.Tensor,
                          center: torch.Tensor, niters: torch.Tensor,
                          k: int = 40, bs: int = 256) -> torch.Tensor:
    """``diffuse_pallas``'s function: from ``T0``, tile b runs
    ``ceil(niters[b]/k)·k`` iterations. ``bs`` (the TPU's block) does not
    change the result."""
    return _diffuse_plain(T0, ids, center, _rounded_counts(niters, k))


def diffuse_blocked(T0: torch.Tensor, ids: torch.Tensor,
                    center: torch.Tensor, niters: torch.Tensor,
                    k: int = 40, bs: int = 256) -> torch.Tensor:
    """T0 and center (B, H, W) f32, ids (B, H, W) int32 (raw labels
    allowed), niters (B,) int32 → T (B, H, W) f32 after
    ``ceil(niters[b]/k)·k`` iterations per tile, bit-identical to the
    plain version. ``bs`` is accepted for the JAX signature and ignored;
    the kernel's own block (64², 8 iterations per launch) is fixed."""
    if int(k) < 1 or int(bs) < 1:
        raise ValueError(f"k={k}, bs={bs}: both must be positive")
    _check_inputs(ids, center, niters, T0)
    if ids.device.type == "cpu":
        return diffuse_blocked_plain(T0, ids, center, niters, k, bs)
    B, H, W = ids.shape
    n_eff = _rounded_counts(niters, int(k)).contiguous()
    nmax = int(n_eff.max()) if B else 0
    if nmax <= 0:
        return T0.clone()
    lib = _build.lib("diffusion_blocked")
    depth = lib.diffusion_blocked_depth()
    stream = _build.stream_ptr(ids.device)
    bufs = (torch.empty_like(T0), torch.empty_like(T0))
    src = T0
    for r in range(-(-nmax // depth)):
        dst = bufs[r % 2]
        _build.check(
            lib.diffusion_blocked_round(
                src.data_ptr(), dst.data_ptr(), ids.data_ptr(),
                center.data_ptr(), n_eff.data_ptr(), B, H, W, r * depth,
                stream),
            "diffusion_blocked_round",
        )
        _build.count("diffuse_blocked")
        src = dst
    return src
