"""Region borders with holes: the counterpart of
``cv2.findContours(mask, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)`` and
``cv2.contourArea``, on the native Suzuki-Abe tracer
(``native/geomfast.cpp`` ``contours_ccomp``).

:func:`find_contours_ccomp` returns cv2's list and hierarchy: the outer
borders in reverse discovery order, each followed by its holes in reverse
discovery order (cv2 prepends a new border to its parent's children and
lists the tree depth first), and rows ``[next, prev, first_child,
parent]``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.geometry.polygons import Polygon
from classpose_tpu_torch.native import load_geomfast


def _trace(mask: np.ndarray):
    """(pts (N, 2) int32, offs (m+1,), parent (m,)) in discovery order."""
    m8 = np.ascontiguousarray(mask != 0, np.uint8)
    H, W = m8.shape
    lib = load_geomfast()
    cap, cap_n = max(4 * (H + W), 1024), max((H * W) // 8, 64)
    while True:
        pts = np.empty((cap, 2), np.int32)
        offs = np.empty(cap_n + 1, np.int64)
        parent = np.empty(cap_n, np.int32)
        m = lib.contours_ccomp(
            m8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), H, W, cap,
            cap_n, pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            parent.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if m >= 0:
            return pts[:offs[m]], offs[:m + 1], parent[:m]
        cap, cap_n = 2 * cap, 2 * cap_n


def find_contours_ccomp(mask: np.ndarray
                        ) -> tuple[list[np.ndarray], np.ndarray]:
    """Borders of the nonzero pixels of a 2-D mask as cv2 gives them:
    (contours, hierarchy), contour k an (N, 2) int32 array of (x, y)
    vertices, hierarchy an (m, 4) int32 array (empty for an empty
    mask)."""
    pts, offs, parent = _trace(mask)
    m = len(parent)
    holes: dict[int, list[int]] = {}
    for i in range(m - 1, -1, -1):
        if parent[i] >= 0:
            holes.setdefault(int(parent[i]), []).append(i)
    outers = [i for i in range(m - 1, -1, -1) if parent[i] < 0]
    order = []
    for o in outers:
        order.append(o)
        order.extend(holes.get(o, []))
    pos = {old: new for new, old in enumerate(order)}
    hier = np.full((m, 4), -1, np.int32)

    def link(ids, par):
        for k, i in enumerate(ids):
            row = hier[pos[i]]
            row[0] = pos[ids[k + 1]] if k + 1 < len(ids) else -1
            row[1] = pos[ids[k - 1]] if k > 0 else -1
            row[3] = par

    link(outers, -1)
    for o in outers:
        kids = holes.get(o, [])
        if kids:
            hier[pos[o], 2] = pos[kids[0]]
            link(kids, pos[o])
    contours = [pts[offs[i]:offs[i + 1]].copy() for i in order]
    return contours, hier


def contour_area(cnt: np.ndarray) -> float:
    """``cv2.contourArea``: the absolute shoelace area of an integer ring
    (0 below 3 vertices; exact, as the products of pixel coordinates
    are)."""
    c = np.asarray(cnt, np.float64).reshape(-1, 2)
    return abs(Polygon._ring_area(c)) if len(c) >= 3 else 0.0
