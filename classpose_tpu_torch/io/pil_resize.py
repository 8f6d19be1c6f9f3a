"""Pillow's 8-bit separable resampling (``libImaging/Resample.c``), bit for
bit, in numpy: what ``Image.resize(size)`` gives an RGB or RGBA image with
Pillow's default filter (BICUBIC, a = -0.5).

Pillow computes each output pixel's filter taps in double precision
(``precompute_coeffs``), rounds them to fixed point with 22 fractional
bits (``normalize_coeffs_8bpc``), and sums integer products from
``1 << 21`` before shifting and clipping, first along rows (only where
the width changes) and then along columns (only where the height
changes). An RGBA image is resized premultiplied (``RGBa``); at alpha 255,
the only alpha the slide readers produce, that conversion and its inverse
are identities, and the alpha channel resamples to 255.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 2.0                                   # BICUBIC's support


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first tap, tap count, fixed-point taps of shape (out, ksize)) of
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the box
    ``(0, in_size)``."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates towards zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):                      # C's order of summation
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * (1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, xmax, kk.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (1: rows, the horizontal pass; 0: columns)
    of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    xmin, xmax, kk = _coefficients(in_size, out_size)
    ksize = kk.shape[1]
    idx = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)   # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for i in range(ksize):
        acc += src[idx[:, i]] * kk[:, i, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size)`` of an (H, W, 3) RGB or
    (H, W, 4) RGBA uint8 array (alpha 255), with ``size`` as PIL takes it:
    (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"resize takes (H, W, 3 or 4) uint8, got "
                         f"{img.dtype} {img.shape}")
    if img.shape[2] == 4 and (img[..., 3] != 255).any():
        raise ValueError("resize takes RGBA at alpha 255 only (Pillow "
                         "premultiplies other alphas)")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize to {size}: sizes must be positive")
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, 1)
    if h != img.shape[0]:
        out = _pass(out, h, 0)
    return out.copy() if out is img else out
