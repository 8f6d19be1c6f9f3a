"""In-memory OpenSlide-compatible reader and synthetic H&E slide
generator (counterpart of ``classpose_tpu/io/array_reader.py``).

``ArraySlide`` wraps a level-0 RGB numpy array (or a ``.npy`` path) as a
pyramid slide: the test and benchmark backend (``WSI_READER=array``).
Regions and thumbnails are numpy arrays, not PIL images; the slide
loader's ``np.asarray(region)[..., :3]`` takes either.

``synthetic_wsi`` draws elliptical "cells" of several classes on a
pinkish background and returns the slide with per-cell ground truth. It
draws the same random numbers in the same order as the JAX package's
generator, so the ground truth is the same for a seed; the ellipses are
filled with numpy (4×4 supersampled edge coverage) where the JAX package
uses ``cv2.ellipse`` with anti-aliasing, so edge pixels differ.
"""

from __future__ import annotations

import numpy as np


class ArraySlide:
    """OpenSlide-compatible facade over a numpy (H, W, 3) uint8 array."""

    def __init__(self, array, mpp: float = 0.25, n_levels: int = 4,
                 properties: dict | None = None):
        if isinstance(array, str):
            array = np.load(array)
        self._level0 = np.asarray(array, np.uint8)
        H, W = self._level0.shape[:2]
        self.level_count = n_levels
        self.level_downsamples = tuple(float(2**i) for i in range(n_levels))
        self.level_dimensions = tuple(
            (max(1, W // 2**i), max(1, H // 2**i)) for i in range(n_levels)
        )
        self.dimensions = self.level_dimensions[0]
        self.properties = {
            "openslide.mpp-x": str(mpp),
            "openslide.mpp-y": str(mpp),
            **(properties or {}),
        }
        self._levels = [self._level0]
        for _ in range(1, n_levels):
            self._levels.append(self._levels[-1][::2, ::2])

    def read_region(self, location, level, size) -> np.ndarray:
        """(h, w, 4) uint8 RGBA at ``level`` from level-0 ``location``;
        outside the slide is transparent black (openslide's contract)."""
        x0, y0 = location
        w, h = size
        ds = int(self.level_downsamples[level])
        lx, ly = x0 // ds, y0 // ds
        arr = self._levels[level]
        out = np.zeros((h, w, 4), np.uint8)
        ys, xs = max(0, ly), max(0, lx)
        ye = min(arr.shape[0], ly + h)
        xe = min(arr.shape[1], lx + w)
        if ye > ys and xe > xs:
            win = (slice(ys - ly, ye - ly), slice(xs - lx, xe - lx))
            out[win + (slice(0, 3),)] = arr[ys:ye, xs:xe]
            out[win + (3,)] = 255
        return out

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 1e-9:
                best = i
        return best

    def get_thumbnail(self, size) -> np.ndarray:
        """RGB of the coarsest level, subsampled to fit within ``size``
        (w, h) with its aspect ratio kept."""
        img = self._levels[-1]
        step = max(1, int(np.ceil(max(img.shape[1] / size[0],
                                      img.shape[0] / size[1]))))
        return np.ascontiguousarray(img[::step, ::step])

    def close(self):
        pass


def _fill_ellipse(img: np.ndarray, center, axes, angle: float,
                  color) -> None:
    """Blend a filled ellipse into ``img`` in place: per pixel, the share
    of 4×4 subsamples inside the ellipse (axes (a, b), rotated by
    ``angle`` degrees as cv2 rotates them)."""
    cx, cy = center
    a, b = max(axes[0], 0.5), max(axes[1], 0.5)
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
    inside = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    cov = inside.reshape(y1 - y0, 4, x1 - x0, 4).mean(axis=(1, 3))
    win = img[y0:y1, x0:x1].astype(np.float64)
    out = win * (1 - cov[..., None]) + np.asarray(color, np.float64) \
        * cov[..., None]
    img[y0:y1, x0:x1] = np.round(out).astype(np.uint8)


def synthetic_wsi(
    width: int = 4096,
    height: int = 4096,
    n_cells: int = 400,
    n_classes: int = 3,
    cell_radius: tuple[int, int] = (8, 16),
    mpp: float = 0.25,
    seed: int = 0,
):
    """Generate a synthetic H&E-like slide with elliptical nuclei.

    Returns ``(ArraySlide, gt)`` where gt is a list of dicts
    {center (x, y), radius, class_id (1-based)}.
    """
    rng = np.random.default_rng(seed)
    img = np.full((height, width, 3), 0, np.uint8)
    # eosin-ish background with mild texture
    img[..., 0] = 235
    img[..., 1] = 205
    img[..., 2] = 225
    if height * width <= 1 << 30:
        noise = rng.normal(0, 4, size=(height, width, 1))
        img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    else:
        # giant slides: the texture in row blocks (another draw order)
        for y0 in range(0, height, 4096):
            y1 = min(y0 + 4096, height)
            blk = img[y0:y1].astype(np.int16) + rng.normal(
                0, 4, size=(y1 - y0, width, 1))
            img[y0:y1] = np.clip(blk, 0, 255).astype(np.uint8)

    class_colors = [
        (90, 60, 140),   # dark purple nuclei
        (60, 90, 160),   # bluish
        (120, 70, 100),  # reddish-purple
        (70, 120, 110),
        (140, 100, 60),
    ]
    gt = []
    occupancy = np.zeros((height, width), bool)
    attempts = 0
    while len(gt) < n_cells and attempts < n_cells * 20:
        attempts += 1
        r = int(rng.integers(cell_radius[0], cell_radius[1] + 1))
        cx = int(rng.integers(r + 2, width - r - 2))
        cy = int(rng.integers(r + 2, height - r - 2))
        y0, y1 = cy - r - 2, cy + r + 3
        x0, x1 = cx - r - 2, cx + r + 3
        if occupancy[y0:y1, x0:x1].any():
            continue
        cls = int(rng.integers(1, n_classes + 1))
        color = class_colors[(cls - 1) % len(class_colors)]
        ax = (int(r * rng.uniform(0.8, 1.0)), int(r * rng.uniform(0.8, 1.0)))
        ang = float(rng.uniform(0, 180))
        _fill_ellipse(img, (cx, cy), ax, ang, color)
        occupancy[y0:y1, x0:x1] = True
        gt.append({"center": (cx, cy), "radius": r, "class_id": cls})
    return ArraySlide(img, mpp=mpp), gt
