"""Synthetic H&E pixels from a seed: the recipe of
``classpose_tpu_torch/io/array_reader.py`` ``synthetic_wsi`` (an eosin
background of (235, 205, 225) with per-pixel grey noise of std 4, then
non-overlapping elliptical nuclei of radius ``radius`` px in one of five
stain colours, edges blended by 4 × 4 supersampling), with the
background made by one ``torch.Generator`` on ``device`` and the nuclei
drawn by numpy from the same seed."""

from __future__ import annotations

import numpy as np
import torch

BACKGROUND = (235, 205, 225)
COLOURS = ((90, 60, 140), (60, 90, 160), (120, 70, 100), (70, 120, 110),
           (140, 100, 60))


def _fill_ellipse(img, cx, cy, a, b, angle, colour):
    a, b = max(a, 0.5), max(b, 0.5)
    r = int(np.ceil(max(a, b))) + 1
    H, W = img.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, H)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, W)
    sub = (np.arange(4) + 0.5) / 4 - 0.5
    yy = (np.arange(y0, y1)[:, None] + sub[None, :]).ravel() - cy
    xx = (np.arange(x0, x1)[:, None] + sub[None, :]).ravel() - cx
    c, s = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
    u = xx[None, :] * c + yy[:, None] * s
    v = -xx[None, :] * s + yy[:, None] * c
    cov = ((u / a) ** 2 + (v / b) ** 2 <= 1.0).reshape(
        y1 - y0, 4, x1 - x0, 4).mean(axis=(1, 3))
    win = img[y0:y1, x0:x1].astype(np.float64)
    out = win * (1 - cov[..., None]) + np.asarray(colour) * cov[..., None]
    img[y0:y1, x0:x1] = np.round(out).astype(np.uint8)


def he_pixels(height: int, width: int, n_nuclei: int, seed: int, device,
              radius=(8, 16), n_classes: int = 3) -> np.ndarray:
    """(height, width, 3) uint8 H&E-like pixels."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn((height, width, 1), generator=gen, device=device)
    base = torch.tensor(BACKGROUND, dtype=torch.float32, device=device)
    img = torch.clamp(torch.round(base + 4.0 * noise), 0, 255).to(
        torch.uint8).cpu().numpy()
    rng = np.random.default_rng(int(seed))
    occupied = np.zeros((height, width), bool)
    placed, attempts = 0, 0
    while placed < n_nuclei and attempts < 20 * n_nuclei:
        attempts += 1
        r = int(rng.integers(radius[0], radius[1] + 1))
        cx = int(rng.integers(r + 2, width - r - 2))
        cy = int(rng.integers(r + 2, height - r - 2))
        win = (slice(cy - r - 2, cy + r + 3), slice(cx - r - 2, cx + r + 3))
        if occupied[win].any():
            continue
        cls = int(rng.integers(0, n_classes))
        a, b = r * rng.uniform(0.8, 1.0), r * rng.uniform(0.8, 1.0)
        _fill_ellipse(img, cx, cy, int(a), int(b), float(rng.uniform(0, 180)),
                      COLOURS[cls % len(COLOURS)])
        occupied[win] = True
        placed += 1
    return img
