"""Heuristic tile relevance filter (counterpart of
``classpose_tpu/pipeline/tile_filter.py``, numpy only): grey-level
histogram gates, the perceptual blur metric of Crete et al. 2007 (what
``skimage.measure.blur_effect`` computes) and HED stain presence with the
fixed Ruifrok matrix.
"""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston H&E-DAB stain separation matrix (rows: H, E, DAB)
RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ]
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED)


def rgb2hed(rgb: np.ndarray) -> np.ndarray:
    """RGB (any range; uint8 assumed 0-255) → HED optical-density space."""
    rgb = np.asarray(rgb, np.float64)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    rgb = np.maximum(rgb, 1e-6)
    od = np.log(rgb) / np.log(1e-6)  # = -log(rgb)/-log(1e-6), skimage conv
    return od @ HED_FROM_RGB


def hed2rgb(hed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb2hed`, returning floats in [0, 1]."""
    od = np.asarray(hed, np.float64) @ RGB_FROM_HED
    rgb = np.power(1e-6, od)  # = exp(od * log(1e-6))
    return np.clip(rgb, 0, 1)


def blur_effect(gray: np.ndarray, h_size: int = 11) -> float:
    """Perceptual blur metric in [0, 1] (1 = blurriest), Crete et al. 2007."""
    gray = np.asarray(gray, np.float64)
    metrics = []
    for axis in (0, 1):
        # strong blur along the axis with a box filter
        k = h_size
        pad = k // 2
        a = np.moveaxis(gray, axis, 0)
        ap = np.pad(a, ((pad, pad), (0, 0)), mode="edge")
        kernel_cum = np.cumsum(ap, axis=0)
        blurred = (
            kernel_cum[k:] - kernel_cum[:-k]
        ) / k
        a_trim = a[: blurred.shape[0]]
        d_orig = np.abs(np.diff(a_trim, axis=0))
        d_blur = np.abs(np.diff(blurred, axis=0))
        d_var = np.maximum(0.0, d_orig - d_blur)
        s_orig = d_orig.sum()
        metrics.append(
            1.0 - (d_var.sum() / s_orig) if s_orig > 0 else 1.0
        )
    return float(np.max(metrics))


def filter_tile(tile: np.ndarray) -> bool:
    """True if the tile looks like informative tissue."""
    grey = tile.mean(-1)
    hist, _ = np.histogram(grey, bins=25, range=[0, 255])
    s = hist.sum()
    if s == 0:
        return False
    hist = hist / s
    am = int(hist.argmax())
    if (
        hist[-1] < 0.25
        and hist[0] < 0.25
        and hist.max() < 0.9
        and am <= 23
    ):
        blur = blur_effect(grey)
        hed_max = rgb2hed(tile).reshape(-1, 3).max(0)
        return bool(
            blur < 0.5 and hed_max[0] > 0.01 and hed_max[1] > 0.01
        )
    return False
