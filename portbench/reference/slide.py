"""Slide tiles as the WSI pipeline reads them, worked out from the slide's
pixels: the tile grid at the read level and OpenCV's ``INTER_LINEAR``
uint8 resize to the model's MPP. Frozen copy of
``classpose_tpu_torch/pipeline/slide_loader.py`` (``_linear_coeffs``,
``resize_linear_u8``, the level choice and ``_coords_full``) for a
single-level array slide whose best level is level 0."""

from __future__ import annotations

import numpy as np


def _linear_coeffs(n_src: int, n_dst: int):
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    lo = s < 0
    f[lo], s[lo] = 0, 0
    hi = s >= n_src - 1
    f[hi], s[hi] = 0, n_src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, np.minimum(s + 1, n_src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_coeffs(w, out_w)
    y0, y1, b0, b1 = _linear_coeffs(h, out_h)
    S = img.astype(np.int32)
    rows = S[:, x0] * a0[None, :, None] + S[:, x1] * a1[None, :, None]
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((b0[:, None, None] * r0) >> 16)
           + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def tile_plan(width: int, height: int, slide_mpp: float, model_mpp: float,
              tile_size: int, overlap: int) -> dict:
    """Level-0 tile origins, read size, output size and the model →
    slide scale, for a slide read at level 0 (``model_mpp / slide_mpp``
    below the next level's downsample of 2)."""
    scale = model_mpp / slide_mpp
    if scale >= 2.0:
        raise ValueError("the reference reads level 0 only")
    resize = 1.0 / scale
    read = max(1, round(tile_size / resize))
    step = max(1, read - max(0, round(overlap / resize)))
    xs = [i for i in range(0, width, step) if i + read <= width]
    ys = [j for j in range(0, height, step) if j + read <= height]
    return dict(origins=[(x, y) for x in xs for y in ys], read=read,
                out=int(round(read * resize)), scale=scale)


def read_tile(slide: np.ndarray, origin, read: int, out: int) -> np.ndarray:
    x, y = origin
    region = np.ascontiguousarray(slide[y:y + read, x:x + read, :3])
    if read == out:
        return region
    return resize_linear_u8(region, out, out)
