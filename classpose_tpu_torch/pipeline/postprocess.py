"""Per-tile post-processing: instance masks → cell polygon features
(counterpart of ``classpose_tpu/pipeline/postprocess.py``, native path).

One native ``contours_batch`` pass over the label image gives every
instance's outer contour (Suzuki-Abe border following, OpenCV's step
order and CHAIN_APPROX_SIMPLE compression, so holes are filled for
export); the vertices are scaled to level-0 slide coordinates; one native
``rings_batch`` call gives every ring's area, centroid, perimeter and
simplicity; self-intersecting or degenerate contours are dropped (QuPath
cannot read them); the class is read at each instance's raster-first
pixel; ids are RFC-4122 v4 UUIDs from one ``os.urandom`` draw.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from classpose_tpu_torch.geometry.polygons import rings_batch_metrics_packed
from classpose_tpu_torch.native import load_geomfast

# matplotlib's "Set3" categorical palette, ×255 and truncated to int
SET3 = (
    (141, 211, 199), (255, 255, 179), (190, 186, 218), (251, 128, 114),
    (128, 177, 211), (253, 180, 98), (179, 222, 105), (252, 205, 229),
    (217, 217, 217), (188, 128, 189), (204, 235, 197), (255, 237, 111),
)

DEFAULT_CELL_COLOR = [0, 168, 132]


def get_colormap() -> list[list[int]]:
    """The class colours: the Set3 palette ×255."""
    return [list(c) for c in SET3]


def _uuid4_batch(m: int) -> list[str]:
    """``m`` canonical RFC-4122 version-4 UUID strings from one urandom
    draw."""
    raw = bytearray(os.urandom(16 * m))
    out = []
    for i in range(m):
        o = 16 * i
        raw[o + 6] = (raw[o + 6] & 0x0F) | 0x40  # version 4
        raw[o + 8] = (raw[o + 8] & 0x3F) | 0x80  # RFC 4122 variant
        h = bytes(raw[o:o + 16]).hex()
        out.append(f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}")
    return out


def contours_batch(masks: np.ndarray):
    """All instances' outer contours in one native pass over the label
    image → (pts int32 (N, 2) x/y in tile coords, offs int64 (m+1,), ids
    int32 (m,), first_px int64 (m,)). Contour k is
    ``pts[offs[k]:offs[k+1]]`` for ascending instance id ``ids[k]``;
    ``first_px`` is the instance's raster-first flat pixel. For an
    instance of several components the contour is the raster-last
    component's, as cv2's first EXTERNAL contour is."""
    lib = load_geomfast()
    m = np.ascontiguousarray(masks, np.int32)
    nmax = int(m.max()) if m.size else 0
    if nmax <= 0:
        return (np.zeros((0, 2), np.int32), np.zeros(1, np.int64),
                np.zeros(0, np.int32), np.zeros(0, np.int64))
    H, W = m.shape
    cap = max(4096, H * W // 8)
    I32 = ctypes.POINTER(ctypes.c_int32)
    L = ctypes.POINTER(ctypes.c_long)
    while True:
        pts = np.empty((cap, 2), np.int32)
        offs = np.zeros(nmax + 2, np.int64)
        ids = np.empty(nmax + 1, np.int32)
        fpx = np.empty(nmax + 1, np.int64)
        n = lib.contours_batch(m.ctypes.data_as(I32), H, W, cap,
                               pts.ctypes.data_as(I32),
                               offs.ctypes.data_as(L),
                               ids.ctypes.data_as(I32),
                               fpx.ctypes.data_as(L))
        if n >= 0:
            return pts, offs[:n + 1], ids[:n], fpx[:n]
        cap *= 2


def process_tile(
    masks: np.ndarray,
    class_masks: np.ndarray | None,
    tile_origin: tuple[float, float],
    prediction_to_slide_scale: float,
    labels: list[str] | None = None,
    colormap: list[list[int]] | None = None,
) -> tuple[list[dict], int]:
    """Extract cell features from one tile's instance (+class) masks.

    ``tile_origin`` is the (x, y) level-0 coordinate of the tile.
    Returns (cells, n_invalid).
    """
    if colormap is None and labels is not None:
        colormap = get_colormap()
    origin = np.array(tile_origin, np.float64)
    pts, offs, inst_ids, fpx = contours_batch(masks)
    xy = pts[:offs[-1]].astype(np.float64) * prediction_to_slide_scale \
        + origin
    if class_masks is not None and labels is not None:
        cls_all = np.ascontiguousarray(class_masks).ravel()[fpx]
    else:
        cls_all = None
    met = rings_batch_metrics_packed(xy, offs)
    valid = ((np.diff(offs) >= 4) & (met[:, 4] > 0)
             & (np.abs(met[:, 0]) >= 1e-12))
    kept = np.flatnonzero(valid)
    n_invalid = int(len(inst_ids) - len(kept))
    uuids = _uuid4_batch(len(kept))

    cells = []
    for j, k in enumerate(kept):
        if cls_all is not None:
            cl_idx = max(int(cls_all[k]) - 1, 0)
            label = labels[cl_idx] if cl_idx < len(labels) else str(cl_idx)
            color = colormap[cl_idx % len(colormap)]
        else:
            label = "cell"
            color = DEFAULT_CELL_COLOR
            cl_idx = 0
        coords = xy[offs[k]:offs[k + 1]].tolist()
        coords.append(list(coords[0]))
        cells.append({
            "id": uuids[j],
            "coords": coords,
            "class_int": cl_idx,
            "area": abs(float(met[k, 0])),
            "label": label,
            "color": color,
            "perimeter": float(met[k, 3]),
            "centroid": [round(float(met[k, 1]), 2),
                         round(float(met[k, 2]), 2)],
        })
    return cells, n_invalid
