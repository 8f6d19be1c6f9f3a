"""Image normalization (counterpart of ``classpose_tpu/ops/normalize.py``
``normalize_img``): per-channel 1st–99th percentile rescaling, with
explicit low/high values, custom percentiles, inversion, and the
sharpen/smooth difference-of-gaussians options.

``integral_stats`` takes the exact path for images whose values are
integers in [0, 255] (uint8 sources): the percentiles are read off a
256-bin cumulative histogram, with the same linear interpolation as a
sorted percentile. Tiled normalization (``tile_norm_blocksize``) is not
ported yet: it is off on the default path.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

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
    if tile_norm_blocksize and tile_norm_blocksize > 0:
        raise NotImplementedError("tiled normalization is not ported yet")

    perc_low, perc_high = (1.0, 99.0) if percentile is None else percentile
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
