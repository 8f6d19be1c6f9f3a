"""Masked heat diffusion for the flow-error QC and the flow targets (one
CUDA kernel + plain PyTorch versions).

Two counterparts of ``classpose_tpu/ops/diffusion_pallas.py``, which run
the same stencil through one kernel body, ``csrc/diffusion.cu``:

- :func:`masked_diffusion` (kernel 4): ``diffuse_resident_pallas`` as the
  fused QC uses it, a batch of tiles from zero, each with its own
  iteration count;
- :func:`diffuse_blocked` (kernel 7): ``diffuse_pallas``, the same
  stencil from a start field ``T0``, with each tile's count rounded up to
  a multiple of ``k``.

A call packs the loop-invariant neighbour matches once, then each launch
runs up to 16 (or 8) iterations of a window in shared memory;
:func:`diffusion_plan` picks the window from the call's shape, so that a
small call still gives the card enough CTAs. The launches are made in C
and counted here under the name of the kernel the caller asked for.
``resident_diffusion_supported`` is the JAX package's gate between its
two designs; ``dynamics/flows.py`` names the route by it.

A wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

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
    kernel (kernel 4's route in the port); the others take its blocked
    design (kernel 7)."""
    return (H % 8 == 0 and W % 128 == 0
            and _RESIDENT_PLANES * H * W * 4 <= _RESIDENT_VMEM_LIMIT)


# ------------------------------------------------------------------ plan

# the windows csrc/diffusion.cu instantiates, by index: (rows, iterations
# per launch, which is also the halo); every window is 128 columns wide
WINDOW_WIDTH = 128
WINDOWS = ((128, 16), (32, 8))
# an H100's SMs. The 128² window runs one CTA an SM; a call with fewer
# than three waves of it loses more to its last, partly filled wave than
# the 32-row window loses to its larger halo (`ab_attention.py
# --windows` on an H100 80GB HBM3 at 700 W: one 448² image, 25 CTAs,
# 2.5× and eight, 200 CTAs, 1.3× faster in 32 rows; 2048², 484 CTAs,
# 4% and 8 × 1024², 968 CTAs, 12% faster in the 128² window)
SMS = 132
FULL_WAVES = 3


@dataclass(frozen=True)
class DiffusionPlan:
    """How one call runs: the window (index into :data:`WINDOWS`), its
    iterations per launch, the grid of CTAs (x, y, batch), whether a
    round's launch may overlap the end of the round before it
    (programmatic dependent launch: on grids of more CTAs than SMs), and
    the launches (one pack, then one per round; none when no tile
    iterates)."""

    window: int
    depth: int
    grid: tuple[int, int, int]
    overlap: bool
    launches: int


def diffusion_plan(B: int, H: int, W: int, nmax: int,
                   window: int | None = None) -> DiffusionPlan:
    """The plan of a call on (B, H, W) tiles whose largest count is
    ``nmax``: the 128² window when its grid fills the card's SMs
    :data:`FULL_WAVES` times, else the 32-row window (4.4× the CTAs for
    the same pixels). ``window`` forces one (for A/B runs)."""
    def grid(w):
        rows, depth = WINDOWS[w]
        return (-(-W // (WINDOW_WIDTH - 2 * depth)),
                -(-H // (rows - 2 * depth)), B)

    if window is None:
        gx, gy, _ = grid(0)
        window = 0 if B * gx * gy >= FULL_WAVES * SMS else 1
    depth = WINDOWS[window][1]
    g = grid(window)
    rounds = -(-max(nmax, 0) // depth)
    return DiffusionPlan(window, depth, g, g[0] * g[1] * g[2] > SMS,
                         1 + rounds if rounds else 0)


# ------------------------------------------------------------ plain version

def _diffuse_plain(T0: torch.Tensor, ids: torch.Tensor,
                   center: torch.Tensor, niter: torch.Tensor,
                   nmax: int | None = None) -> torch.Tensor:
    """From ``T0``, tile b runs ``niter[b]`` iterations of
    ``T ← where(ids>0, Σ_{same-id 3×3 nbrs}(T + cen)·(1/9), 0)``;
    ``nmax`` (≥ max niter) saves reading the counts back."""
    B, H, W = ids.shape
    ids_p = F.pad(ids, (1, 1, 1, 1))
    fg = ids > 0
    cen = center * fg
    ninth = NINTH.to(ids.device)
    T = T0
    if nmax is None:
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


# ------------------------------------------------------------------ kernel

def run_kernel(lib, ids: torch.Tensor, center: torch.Tensor,
               counts: torch.Tensor, nmax: int, T0: torch.Tensor | None,
               window: int | None = None) -> tuple[torch.Tensor, int]:
    """The kernel of ``lib`` (the package's ``diffusion`` library, or a
    build of it for an A/B) on CUDA tensors: tile b runs ``counts[b]``
    iterations from ``T0`` (None: zero); ``nmax`` ≥ max(counts);
    ``window`` overrides the plan's. Returns T and the kernels
    launched."""
    B, H, W = ids.shape
    plan = diffusion_plan(B, H, W, nmax, window)
    if plan.launches == 0:
        return (torch.zeros_like(center) if T0 is None else T0.clone()), 0
    stream = _build.stream_ptr(ids.device)
    cenm = torch.empty_like(center)
    mask = torch.empty((B, H, W), dtype=torch.int16, device=ids.device)
    _build.check(
        lib.diffusion_pack_nbr(ids.data_ptr(), center.data_ptr(),
                               cenm.data_ptr(), mask.data_ptr(), B, H, W,
                               stream),
        "diffusion_pack_nbr",
    )
    out = torch.empty_like(center)
    scratch = torch.empty_like(center) if nmax > plan.depth else None
    launched = ctypes.c_int(0)
    _build.check(
        lib.diffusion_rounds(
            None if T0 is None else T0.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            cenm.data_ptr(), mask.data_ptr(), counts.data_ptr(), B, H, W,
            nmax, plan.window, int(plan.overlap), stream,
            ctypes.addressof(launched)),
        "diffusion_rounds",
    )
    return out, 1 + launched.value


def diffuse_counts_plain(ids: torch.Tensor, center: torch.Tensor,
                         counts: torch.Tensor, nmax: int | None = None,
                         kernel: str = "masked_diffusion",
                         T0: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`diffuse_counts`' plain version on any device (``kernel``
    names no route here)."""
    start = torch.zeros_like(center) if T0 is None else T0
    return _diffuse_plain(start, ids, center, counts, nmax)


def diffuse_counts(ids: torch.Tensor, center: torch.Tensor,
                   counts: torch.Tensor, nmax: int | None = None,
                   kernel: str = "masked_diffusion",
                   T0: torch.Tensor | None = None) -> torch.Tensor:
    """Tile b runs ``counts[b]`` iterations from ``T0`` (None: zero), its
    launches counted as ``kernel``'s. ``nmax`` ≥ max(counts), when the
    caller knows it on the host, saves reading the counts back from the
    device."""
    _check_inputs(ids, center, counts, *(() if T0 is None else (T0,)))
    if ids.device.type == "cpu":
        return diffuse_counts_plain(ids, center, counts, nmax, kernel, T0)
    if nmax is None:
        nmax = int(counts.max()) if counts.numel() else 0
    T, launches = run_kernel(_build.lib("diffusion"), ids, center, counts,
                             nmax, T0)
    _build.count(kernel, launches)
    return T


def masked_diffusion(ids: torch.Tensor, center: torch.Tensor,
                     niter: torch.Tensor) -> torch.Tensor:
    """ids (B, H, W) int32, center (B, H, W) f32, niter (B,) int32 →
    T (B, H, W) f32, bit-identical to the plain version."""
    return diffuse_counts(ids, center, niter, None, "masked_diffusion")


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
    the kernel's window is :func:`diffusion_plan`'s."""
    if int(k) < 1 or int(bs) < 1:
        raise ValueError(f"k={k}, bs={bs}: both must be positive")
    return diffuse_counts(ids, center,
                          _rounded_counts(niters, int(k)).contiguous(),
                          None, "diffuse_blocked", T0)
