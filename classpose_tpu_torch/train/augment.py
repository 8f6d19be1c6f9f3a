"""Geometric training augmentation: random rotate / scale / flip / crop
(counterpart of ``classpose_tpu/train/augment.py``, without OpenCV).

One random affine (rotation θ ∈ [0, 2π), scale ∈ 1 ± scale_range/2
divided by the diameter-rescale factor, horizontal flip, random
translation) crops the sample to ``xy`` and transforms the label channels
consistently: flow vectors are rotated and flipped with the same linear
map, the class channel (categorical ids and −100 sentinels) is warped
with nearest-neighbour sampling, the binary mask and flows bilinearly.

The JAX package warps with ``cv2.warpAffine``; the port builds the same
source → destination map ``M`` and samples with
``scipy.ndimage.affine_transform`` on its inverse, constant zero border.
OpenCV's bilinear warp quantizes each source position to 1/32 pixel and
its nearest warp rounds a position held to 1/1024 pixel, so the two
agree to those quantizations, not bitwise.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _warp(ch: np.ndarray, inv: np.ndarray, offset: np.ndarray,
          shape: tuple[int, int], order: int) -> np.ndarray:
    """Sample ``ch`` at ``inv @ (row, col) + offset`` for every output
    pixel: bilinear (order 1) or nearest (order 0), zero outside."""
    return ndimage.affine_transform(
        np.asarray(ch, np.float32), inv, offset=offset, output_shape=shape,
        order=order, mode="grid-constant", cval=0.0, prefilter=False)


def random_rotate_and_resize(
    img: np.ndarray,
    lbl: np.ndarray | None,
    rescale: float = 1.0,
    scale_range: float = 0.5,
    xy: tuple[int, int] = (256, 256),
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray | None, float]:
    """Apply one random affine to a (C, H, W) image and a (4, H, W) label.

    Returns (img_out (C, *xy), lbl_out (4, *xy), scale). The random draws
    are those of the JAX package, in the same order."""
    rng = rng or np.random.default_rng()
    C, H, W = img.shape
    ds = scale_range
    scale = rng.uniform(1 - ds / 2, 1 + ds / 2)
    if rescale and rescale > 0:
        scale = scale / rescale
    theta = rng.uniform(0, 2 * np.pi)
    flip = rng.random() > 0.5

    cos, sin = np.cos(theta), np.sin(theta)
    A = scale * np.array([[cos, -sin], [sin, cos]])
    if flip:
        A = A @ np.array([[-1.0, 0.0], [0.0, 1.0]])

    # a random source centre that keeps the output window inside the
    # source as far as possible
    out_w, out_h = xy[1], xy[0]
    half_span = np.abs(A) @ np.array([out_w / 2, out_h / 2])
    cx_lo, cx_hi = half_span[0] / scale, W - half_span[0] / scale
    cy_lo, cy_hi = half_span[1] / scale, H - half_span[1] / scale
    cx = rng.uniform(min(cx_lo, cx_hi), max(cx_lo, cx_hi))
    cy = rng.uniform(min(cy_lo, cy_hi), max(cy_lo, cy_hi))
    cx = float(np.clip(cx, 0, W))
    cy = float(np.clip(cy, 0, H))

    # M maps source (x, y) to destination (x, y), centred on the output
    M = np.zeros((2, 3))
    M[:2, :2] = A
    M[:, 2] = [out_w / 2 - (A[0, 0] * cx + A[0, 1] * cy),
               out_h / 2 - (A[1, 0] * cx + A[1, 1] * cy)]
    # its inverse in (row, col) order: destination pixel → source position
    iA = np.linalg.inv(M[:, :2])
    it = -iA @ M[:, 2]
    inv = np.array([[iA[1, 1], iA[1, 0]], [iA[0, 1], iA[0, 0]]])
    offset = np.array([it[1], it[0]])
    shape = (out_h, out_w)

    img_out = np.stack([_warp(img[c], inv, offset, shape, 1)
                        for c in range(C)])

    lbl_out = None
    if lbl is not None:
        chans = []
        for k in range(lbl.shape[0]):
            is_class = k == 0 and lbl.shape[0] >= 2
            chans.append(_warp(lbl[k], inv, offset, shape,
                               0 if is_class else 1))
        lbl_out = np.stack(chans)
        if lbl.shape[0] >= 4:
            # flows are stored (flow_y, flow_x) = (vy, vx); the affine maps
            # (x, y) → A @ (x, y), so the vector (vx, vy) → A @ (vx, vy),
            # renormalized to its old length where flows existed
            vy, vx = lbl_out[-2].copy(), lbl_out[-1].copy()
            new_vx = A[0, 0] * vx + A[0, 1] * vy
            new_vy = A[1, 0] * vx + A[1, 1] * vy
            norm = np.sqrt(new_vx ** 2 + new_vy ** 2)
            scale_back = np.where(norm > 0, 1.0, 0.0)
            old_norm = np.sqrt(vx ** 2 + vy ** 2)
            unit = np.where(norm > 1e-12,
                            old_norm / np.maximum(norm, 1e-12), 0.0)
            lbl_out[-2] = new_vy * unit * scale_back
            lbl_out[-1] = new_vx * unit * scale_back
    return img_out, lbl_out, float(scale)
