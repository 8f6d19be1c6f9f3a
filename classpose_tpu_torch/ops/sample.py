"""Bilinear sampler and landing-position histogram (CUDA kernels + plain
PyTorch versions).

Counterparts of ``classpose_tpu/ops/sample_pallas.py``
``shift_sample_pallas`` and ``scatter_count_pallas``. The TPU kernels
needed a displacement bound ``D`` to size their VMEM stripes; the CUDA
kernels (``csrc/sample.cu``) gather and scatter directly and take none.

A wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from classpose_tpu_torch import _build


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


# ------------------------------------------------------------ bilinear sample

def bilinear_sample_plain(u: torch.Tensor, py: torch.Tensor,
                          px: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) field sampled at (B, H, W) positions, in the TPU
    kernel's factored order: x-lerp on rows y0 and y0+1, then y-lerp."""
    B, C, H, W = u.shape
    y0 = torch.clamp(torch.floor(py), 0, H - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(px), 0, W - 2).to(torch.int64)
    wy = (py - y0.to(py.dtype))[:, None]
    wx = (px - x0.to(px.dtype))[:, None]
    flat = u.reshape(B, C, H * W)
    base = (y0 * W + x0).reshape(B, 1, H * W).expand(B, C, H * W)

    def at(off: int) -> torch.Tensor:
        return torch.gather(flat, 2, base + off).reshape(B, C, H, W)

    g0 = (1 - wx) * at(0) + wx * at(1)
    g1 = (1 - wx) * at(W) + wx * at(W + 1)
    return (1 - wy) * g0 + wy * g1


def bilinear_sample(u: torch.Tensor, py: torch.Tensor,
                    px: torch.Tensor) -> torch.Tensor:
    """Sample (B, C, H, W) f32 ``u`` at f32 positions (B, H, W);
    ``y0 = clip(floor(py), 0, H-2)`` (same for x). Returns (B, C, H, W)."""
    B, C, H, W = u.shape
    _check("u", u, torch.float32, 4, u.device)
    _check("py", py, torch.float32, 3, u.device)
    _check("px", px, torch.float32, 3, u.device)
    if py.shape != (B, H, W) or px.shape != (B, H, W) or H < 2 or W < 2:
        raise ValueError(f"bad shapes {u.shape}, {py.shape}, {px.shape}")
    if u.device.type == "cpu":
        return bilinear_sample_plain(u, py, px)
    _require_cuda(u)
    if H * W >= 2 ** 31 or B > 65535:
        raise ValueError(f"kernel takes H·W < 2^31 and B ≤ 65535, got "
                         f"{tuple(u.shape)}")
    out = torch.empty_like(u)
    _build.call("sample", "bilinear_sample_f32", u.device,
                u.data_ptr(), py.data_ptr(), px.data_ptr(), out.data_ptr(),
                B, C, H, W)
    _build.count("bilinear_sample")
    return out


# --------------------------------------------------------- landing histogram

def landing_histogram_plain(fy: torch.Tensor, fx: torch.Tensor,
                            cell: torch.Tensor) -> torch.Tensor:
    """``zeros.at[fy·W + fx].add(cell)`` per batch element, via
    ``index_add_``."""
    B, H, W = fy.shape
    flat = (
        torch.arange(B, device=fy.device, dtype=torch.int64)[:, None, None]
        * (H * W) + fy.to(torch.int64) * W + fx.to(torch.int64)
    )
    out = torch.zeros(B * H * W, dtype=torch.float32, device=fy.device)
    out.index_add_(0, flat.reshape(-1), cell.reshape(-1))
    return out.reshape(B, H, W)


def landing_histogram(fy: torch.Tensor, fx: torch.Tensor,
                      cell: torch.Tensor) -> torch.Tensor:
    """Histogram of integer landing positions: ``out[b, y, x] = Σ_i
    cell[b, i]·[fy[b, i] == y]·[fx[b, i] == x]``. fy/fx int32 in range,
    cell f32, all (B, H, W). Exact: counts are small-integer f32 sums."""
    B, H, W = fy.shape
    _check("fy", fy, torch.int32, 3, fy.device)
    _check("fx", fx, torch.int32, 3, fy.device)
    _check("cell", cell, torch.float32, 3, fy.device)
    if fx.shape != fy.shape or cell.shape != fy.shape:
        raise ValueError(f"bad shapes {fy.shape}, {fx.shape}, {cell.shape}")
    if fy.device.type == "cpu":
        return landing_histogram_plain(fy, fx, cell)
    _require_cuda(fy)
    if H * W >= 2 ** 31 or B > 65535:
        raise ValueError(f"kernel takes H·W < 2^31 and B ≤ 65535, got "
                         f"{tuple(fy.shape)}")
    out = torch.empty((B, H, W), dtype=torch.float32, device=fy.device)
    _build.call("sample", "landing_histogram_f32", fy.device,
                fy.data_ptr(), fx.data_ptr(), cell.data_ptr(),
                out.data_ptr(), B, H, W)
    _build.count("landing_histogram")
    return out
