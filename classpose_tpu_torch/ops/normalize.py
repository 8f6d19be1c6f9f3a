"""Image normalization (counterpart of ``classpose_tpu/ops/normalize.py``
``normalize_img``): per-channel 1st–99th percentile rescaling, with
explicit low/high values, custom percentiles, inversion, and the
sharpen/smooth difference-of-gaussians options.

``integral_stats`` takes the exact path for images whose values are
integers in [0, 255] (uint8 sources): the percentiles are read off a
256-bin cumulative histogram, with the same linear interpolation as a
sorted percentile. ``tile_norm_blocksize > 0`` normalizes with smoothed
blockwise percentiles (``_tile_normalize``).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from classpose_tpu_torch.ops.resize import resize

NORMALIZE_DEFAULT: dict[str, Any] = {
    "lowhigh": None,
    "percentile": None,
    "normalize": True,
    "norm3D": True,
    "sharpen_radius": 0,
    "smooth_radius": 0,
    "tile_norm_blocksize": 0,
    "tile_norm_smooth3D": 1,
    "invert": False,
    "percentile_subsample": 1,
}


def _blur2d(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable gaussian blur over the last two axes (σ = radius/2),
    edge-padded."""
    sigma = max(radius / 2.0, 0.5)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def conv_axis(a, axis):
        a = a.movedim(axis, -1)
        shp = a.shape
        ap = F.pad(a.reshape(-1, 1, shp[-1]), (radius, radius),
                   mode="replicate").reshape(*shp[:-1], shp[-1] + 2 * radius)
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap[..., i:i + shp[-1]]
        return out.movedim(-1, axis)

    return conv_axis(conv_axis(img, -2), -1)


def _integral_percentile(img: torch.Tensor, qs, ax: int):
    """Exact per-channel percentiles of integer-valued [0, 255] data from
    a 256-bin cumulative histogram."""
    C = img.shape[ax]
    flat = img.movedim(ax, 0).reshape(C, -1)
    N = flat.shape[1]
    counts = torch.zeros((C, 256), dtype=torch.int64, device=img.device)
    counts.scatter_add_(1, flat.to(torch.int64),
                        torch.ones_like(flat, dtype=torch.int64))
    cum = torch.cumsum(counts, dim=1)

    def at_rank(rank: float):
        k = int(math.floor(rank))
        frac = torch.tensor(rank - k, dtype=torch.float32)
        v_k = (cum <= k).sum(dim=1).to(torch.float32)
        v_k1 = (cum <= k + 1).sum(dim=1).to(torch.float32)
        return v_k + frac.to(img.device) * (v_k1 - v_k)

    shape = [1] * img.ndim
    shape[ax] = C
    return [at_rank(q / 100.0 * (N - 1)).reshape(shape) for q in qs]


def normalize_img(
    img: torch.Tensor,
    axis: int = -1,
    lowhigh: tuple[float, float] | None = None,
    percentile: tuple[float, float] | None = None,
    normalize: bool = True,
    invert: bool = False,
    sharpen_radius: int = 0,
    smooth_radius: int = 0,
    tile_norm_blocksize: int = 0,
    percentile_subsample: int = 1,
    integral_stats: bool = False,
    **_ignored,
) -> torch.Tensor:
    """Normalize so 0.0 ≈ 1st and 1.0 ≈ 99th percentile per channel
    (channel axis ``axis``), cellpose semantics."""
    img = img.to(torch.float32)
    ax = axis % img.ndim
    if sharpen_radius > 0:
        img = img - _blur2d(img, int(sharpen_radius))
    if smooth_radius > 0:
        img = _blur2d(img, int(smooth_radius))
    if not normalize:
        return img
    if lowhigh is not None:
        low, high = lowhigh
        img = (img - low) / max(high - low, 1e-6)
        return 1.0 - img if invert else img
    perc_low, perc_high = (1.0, 99.0) if percentile is None else percentile
    if tile_norm_blocksize and tile_norm_blocksize > 0:
        return _tile_normalize(img, ax, perc_low, perc_high,
                               int(tile_norm_blocksize), invert)
    if integral_stats:
        x01, x99 = _integral_percentile(img, (perc_low, perc_high), ax)
    else:
        src = img
        if percentile_subsample > 1 and img.ndim >= 2:
            d = int(percentile_subsample)
            sl = [slice(None, None, d)] * img.ndim
            sl[ax] = slice(None)
            src = img[tuple(sl)]
        flat = src.movedim(ax, 0).reshape(src.shape[ax], -1)
        q = torch.tensor([perc_low / 100.0, perc_high / 100.0],
                         dtype=torch.float32, device=img.device)
        x01, x99 = torch.quantile(flat, q, dim=1)
        shape = [1] * img.ndim
        shape[ax] = img.shape[ax]
        x01, x99 = x01.reshape(shape), x99.reshape(shape)
    scale = torch.clamp(x99 - x01, min=1e-3)
    out = (img - x01) / scale
    return 1.0 - out if invert else out


TILE_NORM_OVERLAP = 0.1  # cellpose tile_overlap for normalization blocks
TILE_NORM_SMOOTH_SIGMA = 1.0  # gaussian sigma over the block-stat grid
_SMOOTH_TRUNCATE = 4.0  # scipy.ndimage.gaussian_filter default


def tile_grid_starts(L: int, blocksize: int,
                     overlap: float = TILE_NORM_OVERLAP) -> np.ndarray:
    """Overlapping block starts: ``ceil((1+2·overlap)·L/bs)`` blocks spread
    by linspace (cellpose ``normalize99_tile``'s grid)."""
    if L <= blocksize:
        return np.zeros(1, int)
    n = int(np.ceil((1.0 + 2.0 * overlap) * L / blocksize))
    return np.linspace(0, L - blocksize, n).astype(int)


def _smooth_grid(g: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian smoothing of the (B, ny, nx, C) block-stat grid over the
    grid axes with scipy ``gaussian_filter(mode="reflect")`` semantics
    (truncate 4σ, edge sample repeated)."""
    radius = int(_SMOOTH_TRUNCATE * sigma + 0.5)
    if radius < 1:
        return g
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=g.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def conv_axis(a, axis):
        n = a.shape[axis]
        if n == 1:
            return a
        a = a.movedim(axis, -1)
        ap, pad = a, radius
        while pad > 0:  # symmetric padding wider than the axis: chained
            p = min(pad, ap.shape[-1] - 1) if ap.shape[-1] > 1 else pad
            ap = torch.cat([ap[..., :p].flip(-1), ap,
                            ap[..., ap.shape[-1] - p:].flip(-1)], dim=-1)
            pad -= p
        out = torch.zeros_like(a)
        for i in range(2 * radius + 1):
            out = out + k[i] * ap[..., i:i + n]
        return out.movedim(-1, axis)

    return conv_axis(conv_axis(g, 1), 2)


def _tile_normalize(img: torch.Tensor, ax: int, perc_low: float,
                    perc_high: float, blocksize: int, invert: bool
                    ) -> torch.Tensor:
    """Smoothed blockwise percentile normalization (counterpart of the JAX
    ``_tile_normalize``): per-block, per-channel percentiles on the
    overlapping grid, gaussian smoothing (σ = 1 grid cell) of the two stat
    grids, linear (half-pixel) upsampling to full resolution, then
    ``(x − low) / max(high − low, 1e-3)``."""
    x = img.movedim(ax, -1)
    *lead, Ly, Lx, C = x.shape
    x2 = x.reshape(-1, Ly, Lx, C)
    blocksize = min(blocksize, Ly, Lx)
    ys = tile_grid_starts(Ly, blocksize)
    xs = tile_grid_starts(Lx, blocksize)
    q = torch.tensor([perc_low / 100.0, perc_high / 100.0],
                     dtype=torch.float32, device=img.device)
    stats = torch.stack([
        torch.stack([
            torch.quantile(
                x2[:, y0:y0 + blocksize, x0:x0 + blocksize].reshape(
                    x2.shape[0], -1, C), q, dim=1)
            for x0 in (int(v) for v in xs)], dim=2)
        for y0 in (int(v) for v in ys)], dim=2)  # (2, B, ny, nx, C)
    lows = _smooth_grid(stats[0], TILE_NORM_SMOOTH_SIGMA)
    highs = _smooth_grid(stats[1], TILE_NORM_SMOOTH_SIGMA)
    full = (x2.shape[0], Ly, Lx, C)
    low_full = resize(lows, full)
    high_full = resize(highs, full)
    out = (x2 - low_full) / torch.clamp(high_full - low_full, min=1e-3)
    if invert:
        out = 1.0 - out
    return out.reshape(*lead, Ly, Lx, C).movedim(-1, ax)
