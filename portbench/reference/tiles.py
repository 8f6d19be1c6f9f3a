"""Crop grid, crops and the taper-window blend, in float32.

Frozen copy of the plain functions of ``classpose_tpu_torch/ops/tiles.py``
without test-time augmentation (no cell uses it): cellpose's grid
(n = 1 if L <= bsize else ceil((1 + 2·overlap)·L / bsize), starts
round(linspace(0, L − bsize, n))) and the separable sigmoid taper
1 / (1 + exp((|x − c| − (bsize/2 − 20)) / 7.5)).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def get_pad_yx(Ly: int, Lx: int, min_size: tuple[int, int]):
    ypad = max(0, min_size[0] - Ly)
    xpad = max(0, min_size[1] - Lx)
    return ypad // 2, ypad - ypad // 2, xpad // 2, xpad - xpad // 2


@dataclasses.dataclass(frozen=True)
class TileGrid:
    Ly: int
    Lx: int
    bsize: int
    ystart: tuple[int, ...]
    xstart: tuple[int, ...]

    @property
    def ntiles(self) -> int:
        return len(self.ystart) * len(self.xstart)


def _starts(L: int, bsize: int, n: int) -> tuple[int, ...]:
    if n == 1:
        return (0,)
    return tuple(int(round(v)) for v in np.linspace(0, max(0, L - bsize), n))


def compute_tile_grid(Ly: int, Lx: int, bsize: int, tile_overlap: float = 0.1
                      ) -> TileGrid:
    ny = 1 if Ly <= bsize else int(math.ceil((1 + 2 * tile_overlap) * Ly
                                             / bsize))
    nx = 1 if Lx <= bsize else int(math.ceil((1 + 2 * tile_overlap) * Lx
                                             / bsize))
    return TileGrid(Ly, Lx, bsize, _starts(Ly, bsize, ny),
                    _starts(Lx, bsize, nx))


def make_tiles(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """(C, Ly, Lx) → (ntiles, C, bsize, bsize), row-major over the grid."""
    b = grid.bsize
    return torch.stack([img[:, ys:ys + b, xs:xs + b]
                        for ys in grid.ystart for xs in grid.xstart])


def _mask1d(bsize: int) -> np.ndarray:
    xm = np.arange(bsize, dtype=np.float32)
    xm = np.abs(xm - xm.mean())
    return (1.0 / (1.0 + np.exp((xm - (bsize / 2 - 20)) / 7.5))).astype(
        np.float32)


def average_tiles(y: torch.Tensor, grid: TileGrid, eps: float = 1e-12
                  ) -> torch.Tensor:
    """(ntiles, C, b, b) → (C, Ly, Lx): the taper-weighted mean."""
    b = grid.bsize
    m1 = torch.from_numpy(_mask1d(b)).to(y.device)
    mask = m1[:, None] * m1[None, :]
    out = torch.zeros((y.shape[1], grid.Ly, grid.Lx), device=y.device)
    navg = torch.zeros((grid.Ly, grid.Lx), device=y.device)
    k = 0
    for ys in grid.ystart:
        for xs in grid.xstart:
            out[:, ys:ys + b, xs:xs + b] += y[k].float() * mask
            navg[ys:ys + b, xs:xs + b] += mask
            k += 1
    return out / (navg + eps)
