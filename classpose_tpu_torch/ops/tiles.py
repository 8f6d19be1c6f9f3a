"""Overlapping-tile extraction and taper-window overlap averaging
(counterpart of ``classpose_tpu/ops/tiles.py``).

The tile grid is computed from the image shape in plain Python ints.
Every function takes arbitrary leading batch dimensions: ``make_tiles``
maps (..., C, Ly, Lx) to (..., ntiles, C, b, b) and the blends map back.

Conventions (cellpose's):
- grid without TTA: n = 1 if L <= bsize else ceil((1 + 2·overlap)·L/bsize),
  starts = round(linspace(0, L − bsize, n));
- TTA ("augment") grid: n = max(2, ceil(2·L/bsize)) with the parity flips
  (j even, i odd) → flip y, (j odd, i even) → flip x, (j odd, i odd) → both;
  flow channels are sign-corrected on unaugment, class channels only
  un-flipped;
- taper window: separable sigmoid 1/(1+exp((|x−c|−(bsize/2−20))/7.5)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_pad_yx(Ly: int, Lx: int, min_size: tuple[int, int]
               ) -> tuple[int, int, int, int]:
    """Symmetric padding so each dim is at least ``min_size``."""
    ypad = max(0, min_size[0] - Ly)
    xpad = max(0, min_size[1] - Lx)
    ypad1, xpad1 = ypad // 2, xpad // 2
    return ypad1, ypad - ypad1, xpad1, xpad - xpad1


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static description of an overlapping tile grid over (Ly, Lx)."""

    Ly: int
    Lx: int
    bsize: int
    ny: int
    nx: int
    ystart: tuple[int, ...]
    xstart: tuple[int, ...]
    augment: bool

    @property
    def ntiles(self) -> int:
        return self.ny * self.nx


def _starts(L: int, bsize: int, n: int) -> tuple[int, ...]:
    if n == 1:
        return (0,)
    return tuple(int(round(v)) for v in np.linspace(0, max(0, L - bsize), n))


def compute_tile_grid(Ly: int, Lx: int, bsize: int = 256,
                      tile_overlap: float = 0.1, augment: bool = False
                      ) -> TileGrid:
    if augment:
        ny = max(2, int(math.ceil(2.0 * Ly / bsize)))
        nx = max(2, int(math.ceil(2.0 * Lx / bsize)))
    else:
        ny = 1 if Ly <= bsize else int(
            math.ceil((1.0 + 2 * tile_overlap) * Ly / bsize))
        nx = 1 if Lx <= bsize else int(
            math.ceil((1.0 + 2 * tile_overlap) * Lx / bsize))
    return TileGrid(Ly=Ly, Lx=Lx, bsize=bsize, ny=ny, nx=nx,
                    ystart=_starts(Ly, bsize, ny),
                    xstart=_starts(Lx, bsize, nx), augment=augment)


def _flip_for_parity(t: torch.Tensor, j: int, i: int) -> torch.Tensor:
    if j % 2 == 0 and i % 2 == 1:
        return t.flip(-2)
    if j % 2 == 1 and i % 2 == 0:
        return t.flip(-1)
    if j % 2 == 1 and i % 2 == 1:
        return t.flip(-2, -1)
    return t


def make_tiles(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(..., C, Ly, Lx) → (..., ntiles, C, bsize, bsize)."""
    b = grid.bsize
    tiles = []
    for j, ys in enumerate(grid.ystart):
        for i, xs in enumerate(grid.xstart):
            t = img[..., ys:ys + b, xs:xs + b]
            if grid.augment:
                t = _flip_for_parity(t, j, i)
            tiles.append(t)
    return torch.stack(tiles, dim=-4)


def unaugment_tiles(y: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Undo TTA flips on flow predictions (..., ntiles, 3, b, b), with the
    flow components sign-corrected."""
    out = []
    k = 0
    for j in range(grid.ny):
        for i in range(grid.nx):
            t = _flip_for_parity(y[..., k, :, :, :], j, i).clone()
            if j % 2 == 1 or i % 2 == 1:
                if i % 2 == 1:
                    t[..., 0, :, :] *= -1
                if j % 2 == 1:
                    t[..., 1, :, :] *= -1
            out.append(t)
            k += 1
    return torch.stack(out, dim=-4)


def unaugment_class_tiles(y: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """Undo TTA flips on class predictions, without sign correction."""
    out = []
    k = 0
    for j in range(grid.ny):
        for i in range(grid.nx):
            out.append(_flip_for_parity(y[..., k, :, :, :], j, i))
            k += 1
    return torch.stack(out, dim=-4)


def _mask1d(bsize: int) -> np.ndarray:
    xm = np.arange(bsize, dtype=np.float32)
    xm = np.abs(xm - xm.mean())
    return (1.0 / (1.0 + np.exp((xm - (bsize / 2 - 20)) / 7.5))).astype(
        np.float32)


def taper_mask(bsize: int = 256) -> np.ndarray:
    m = _mask1d(bsize)
    return (m[:, None] * m[None, :]).astype(np.float32)


def _acc_dtype(y: torch.Tensor) -> torch.dtype:
    return y.dtype if y.dtype == torch.bfloat16 else torch.float32


def average_tiles(y: torch.Tensor, grid: TileGrid, eps: float = 1e-12
                  ) -> torch.Tensor:
    """Blend (..., ntiles, C, b, b) into (..., C, Ly, Lx) f32 with the
    taper window, accumulating in the input dtype (bf16 or f32)."""
    b = grid.bsize
    acc_t = _acc_dtype(y)
    mask = torch.from_numpy(taper_mask(b)).to(y.device)
    mask_acc = mask.to(acc_t)
    lead = y.shape[:-4]
    yf = torch.zeros((*lead, y.shape[-3], grid.Ly, grid.Lx), dtype=acc_t,
                     device=y.device)
    navg = torch.zeros((grid.Ly, grid.Lx), dtype=torch.float32,
                       device=y.device)
    k = 0
    for ys in grid.ystart:
        for xs in grid.xstart:
            yf[..., ys:ys + b, xs:xs + b] += (
                y[..., k, :, :, :].to(acc_t) * mask_acc)
            navg[ys:ys + b, xs:xs + b] += mask
            k += 1
    return yf.float() / (navg + eps)


def _blend_1d(pieces, starts, bsize: int, L: int, axis: int,
              mask1d: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Blend equal-size slabs along ``axis`` (negative) into length L:
    exclusive segments are copied, pairwise overlaps weight-averaged."""
    n = len(pieces)
    if n == 1:
        return pieces[0]

    def seg(piece, lo, hi):
        return piece.narrow(axis, lo, hi - lo)

    def wseg(i, j, lo, hi):
        shape = [1] * (-axis)
        shape[0] = hi - lo
        wi = mask1d[lo - starts[i]:hi - starts[i]].reshape(shape)
        wj = mask1d[lo - starts[j]:hi - starts[j]].reshape(shape)
        a = seg(pieces[i], lo - starts[i], hi - starts[i])
        b = seg(pieces[j], lo - starts[j], hi - starts[j])
        return (a * wi + b * wj) / (wi + wj + eps)

    out = []
    cursor = 0
    for i in range(n):
        end_i = starts[i] + bsize
        nxt = starts[i + 1] if i + 1 < n else L
        excl_hi = min(end_i, nxt)
        if excl_hi > cursor:
            out.append(seg(pieces[i], cursor - starts[i],
                           excl_hi - starts[i]))
            cursor = excl_hi
        if i + 1 < n and end_i > nxt:
            out.append(wseg(i, i + 1, nxt, end_i))
            cursor = end_i
    return torch.cat(out, dim=axis)


def average_tiles_separable(y: torch.Tensor, grid: TileGrid,
                            eps: float = 1e-12) -> torch.Tensor:
    """Same result as :func:`average_tiles` for grids where at most two
    tiles overlap per axis (no TTA): a separable two-pass blend. Falls
    back to :func:`average_tiles` otherwise."""
    b = grid.bsize

    def pairwise_ok(starts):
        return all(starts[i + 2] >= starts[i] + b
                   for i in range(len(starts) - 2))

    if grid.augment or not pairwise_ok(grid.ystart) \
            or not pairwise_ok(grid.xstart):
        return average_tiles(y, grid, eps)
    acc_t = _acc_dtype(y)
    m1d = torch.from_numpy(_mask1d(b)).to(y.device).to(acc_t)
    lead = y.shape[:-4]
    yv = y.to(acc_t).reshape(*lead, grid.ny, grid.nx, *y.shape[-3:])
    rows = [
        _blend_1d([yv[..., j, i, :, :, :] for i in range(grid.nx)],
                  grid.xstart, b, grid.Lx, -1, m1d, eps)
        for j in range(grid.ny)
    ]
    out = _blend_1d(rows, grid.ystart, b, grid.Ly, -2, m1d, eps)
    return out.float()
