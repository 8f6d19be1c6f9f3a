"""Polygon primitives: shoelace metrics, containment, validity, repair
(counterpart of ``classpose_tpu/geometry/polygons.py``, on the port's
native core).

The metrics, containment and self-intersection tests run in
``native/geomfast.cpp``; :func:`make_valid` is the exact even-odd planar
arrangement in numpy, and :func:`intersection_area` (the per-ROI artefact
correction) the exact boundary integral. The JAX package's cv2
rasterizing fallback of ``make_valid`` is not kept: an input the exact
repair cannot handle raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.native import load_geomfast

_D = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray, kind=_D):
    return a.ctypes.data_as(kind)


def _ring_metrics(r: np.ndarray) -> tuple[float, float, float, float]:
    """(signed_area, cx, cy, perimeter) of one open ring."""
    rc = np.ascontiguousarray(r, np.float64)
    out = np.empty(4, np.float64)
    load_geomfast().ring_metrics(_ptr(rc), len(rc), _ptr(out))
    return float(out[0]), float(out[1]), float(out[2]), float(out[3])


class Polygon:
    """A simple polygon with optional holes.

    ``exterior``: (N, 2) array of (x, y); closed or open rings accepted
    (a closing vertex equal to the first is dropped internally).
    """

    __slots__ = ("exterior", "holes", "_bounds", "_rm")

    def __init__(self, exterior, holes=None):
        ext = np.asarray(exterior, np.float64)
        # np.allclose(ext[0], ext[-1]) without its per-call machinery
        if len(ext) >= 2 and (
            abs(ext[0, 0] - ext[-1, 0]) <= 1e-8 + 1e-5 * abs(ext[-1, 0])
            and abs(ext[0, 1] - ext[-1, 1]) <= 1e-8 + 1e-5 * abs(ext[-1, 1])
        ):
            ext = ext[:-1]
        self.exterior = ext
        self.holes = [
            np.asarray(h, np.float64)[
                : -1 if len(h) >= 2 and np.allclose(h[0], h[-1]) else None
            ]
            for h in (holes or [])
        ]
        self._bounds = None
        self._rm = None

    @property
    def _ext_metrics(self) -> tuple[float, float, float, float]:
        """Cached (signed_area, cx, cy, perimeter) of the exterior."""
        if self._rm is None:
            self._rm = _ring_metrics(self.exterior)
        return self._rm

    @staticmethod
    def _ring_area(r: np.ndarray) -> float:
        return _ring_metrics(r)[0]

    @property
    def area(self) -> float:
        a = abs(self._ext_metrics[0])
        for h in self.holes:
            a -= abs(_ring_metrics(h)[0])
        return a

    @property
    def length(self) -> float:
        total = self._ext_metrics[3]
        for h in self.holes:
            total += _ring_metrics(h)[3]
        return total

    @property
    def centroid(self) -> tuple[float, float]:
        m = self._ext_metrics
        return m[1], m[2]

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        if self._bounds is None:
            e = self.exterior
            self._bounds = (
                float(e[:, 0].min()), float(e[:, 1].min()),
                float(e[:, 0].max()), float(e[:, 1].max()),
            )
        return self._bounds

    def contains_point(self, x: float, y: float) -> bool:
        return bool(self.contains_points(np.array([[x, y]]))[0])

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        """Containment of (N, 2) points (inside the exterior, outside
        every hole)."""
        pts = np.asarray(pts, np.float64)
        inside = _points_in_ring(self.exterior, pts)
        for h in self.holes:
            inside &= ~_points_in_ring(h, pts)
        return inside

    @property
    def is_valid(self) -> bool:
        """True if the exterior ring is simple (no self-intersection) and
        has nonzero area."""
        r = self.exterior
        if len(r) < 3:
            return False
        if abs(self._ext_metrics[0]) < 1e-12:
            return False
        return not _ring_self_intersects(r)


def rings_batch_metrics_packed(xy: np.ndarray,
                               offs: np.ndarray) -> np.ndarray:
    """(m, 5) [signed_area, cx, cy, perimeter, simple] for m open rings
    packed in one (N, 2) float64 buffer with (m+1,) vertex offsets, in
    one native call."""
    m = len(offs) - 1
    out = np.empty((m, 5), np.float64)
    if m == 0:
        return out
    xc = np.ascontiguousarray(xy, np.float64)
    oc = np.ascontiguousarray(offs, np.int64)
    load_geomfast().rings_batch(_ptr(xc), _ptr(oc, ctypes.POINTER(
        ctypes.c_long)), m, _ptr(out))
    return out


def _points_in_ring(ring: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Ray-casting parity of (N, 2) points against one ring."""
    out = np.zeros(len(pts), np.uint8)
    if len(ring) and len(pts):
        rc = np.ascontiguousarray(ring, np.float64)
        pc = np.ascontiguousarray(pts, np.float64)
        load_geomfast().points_in_ring(_ptr(rc), len(rc), _ptr(pc), len(pc),
                                       _ptr(out, ctypes.POINTER(
                                           ctypes.c_ubyte)))
    return out.astype(bool)


def _ring_self_intersects(ring: np.ndarray) -> bool:
    """Any proper intersection of two non-adjacent edges (endpoint
    touching and collinear overlap do not count)."""
    if len(ring) < 4:
        return False
    rc = np.ascontiguousarray(ring, np.float64)
    return not bool(load_geomfast().ring_simple(_ptr(rc), len(rc)))


# --------------------------------------------------------------------------
# Exact make_valid: even-odd repair of a self-intersecting ring via a
# planar arrangement. Node every segment at its pairwise intersections,
# classify the fill parity on each side of every sub-edge (even-odd ray
# cast at an ε-offset midpoint against the ORIGINAL ring), keep the
# directed edges with odd fill on their left, and trace them into closed
# rings with the most-clockwise-turn rule. CCW output rings are exteriors.
# --------------------------------------------------------------------------


def _segment_cross_params(p: np.ndarray, q: np.ndarray,
                          ring: np.ndarray) -> np.ndarray:
    """Parameters t ∈ (0, 1) where segment p + t(q−p) meets ring edges
    (vectorized over the ring; includes touching/collinear endpoints)."""
    d = q - p
    a = ring
    b = np.roll(ring, -1, axis=0)
    e = b - a
    denom = d[0] * e[:, 1] - d[1] * e[:, 0]
    w = a - p
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w[:, 0] * e[:, 1] - w[:, 1] * e[:, 0]) / denom
        u = (w[:, 0] * d[1] - w[:, 1] * d[0]) / denom
    ok = np.isfinite(t) & np.isfinite(u)
    ok &= (t > 0.0) & (t < 1.0) & (u >= 0.0) & (u <= 1.0)
    ts = [t[ok]]
    # collinear edges: split at the projections of the ring edge's
    # endpoints onto pq
    col = (np.abs(denom) < 1e-30) & (
        np.abs(w[:, 0] * d[1] - w[:, 1] * d[0]) < 1e-12
    )
    if col.any():
        dd = float(d @ d)
        if dd > 0:
            for pt in (a[col], b[col]):
                tp = (pt - p) @ d / dd
                ts.append(tp[(tp > 0.0) & (tp < 1.0)])
    return np.concatenate(ts)


def _node_segments(ring: np.ndarray):
    """Split ring edges at all pairwise intersections. Returns a list of
    (key_a, key_b, a, b) sub-segments with coordinates snapped to
    1e-9·scale."""
    n = len(ring)
    scale = float(max(np.ptp(ring[:, 0]), np.ptp(ring[:, 1]), 1.0))
    snap = 1e-9 * scale
    segs = []
    for i in range(n):
        p = ring[i]
        q = ring[(i + 1) % n]
        if ((q - p) ** 2).sum() < snap * snap:
            continue
        ts = [np.array([0.0, 1.0]), _segment_cross_params(p, q, ring)]
        t = np.unique(np.clip(np.concatenate(ts), 0.0, 1.0))
        d = q - p
        for t0, t1 in zip(t[:-1], t[1:]):
            a = p + t0 * d
            b = p + t1 * d
            if ((b - a) ** 2).sum() >= snap * snap:
                segs.append((a, b))

    def key(pt):
        return (round(float(pt[0]) / snap), round(float(pt[1]) / snap))

    verts: dict = {}
    out = []
    for a, b in segs:
        ka, kb = key(a), key(b)
        if ka == kb:
            continue
        va = verts.setdefault(ka, np.array(a, np.float64))
        vb = verts.setdefault(kb, np.array(b, np.float64))
        out.append((ka, kb, va, vb))
    return out


def _parity(pt: np.ndarray, ring: np.ndarray) -> int:
    """Even-odd crossing parity of ``pt`` against the original ring."""
    return int(_points_in_ring(ring, pt[None, :])[0])


def make_valid(coords: np.ndarray) -> list[np.ndarray]:
    """Repair a (possibly self-intersecting) ring into simple CCW rings
    covering its even-odd fill (holes of the repaired region are
    dropped; no caller needs them)."""
    coords = np.asarray(coords, np.float64)
    if len(coords) >= 2 and np.allclose(coords[0], coords[-1]):
        coords = coords[:-1]
    if len(coords) < 3:
        return []
    return _make_valid_exact(coords)


def _make_valid_exact(ring: np.ndarray) -> list[np.ndarray]:
    scale = float(max(np.ptp(ring[:, 0]), np.ptp(ring[:, 1]), 1.0))
    eps = 1e-7 * scale
    noded = _node_segments(ring)
    if not noded:
        return []

    # directed edges with ODD fill on the left (interior-on-left)
    kept: dict = {}  # tail key -> list of (head key, tail pt, head pt)
    for ka, kb, a, b in noded:
        d = b - a
        ln = float(np.hypot(d[0], d[1]))
        if ln <= 0:
            continue
        nrm = np.array([-d[1], d[0]]) / ln  # left normal of a→b
        mid = 0.5 * (a + b)
        left = _parity(mid + eps * nrm, ring)
        right = _parity(mid - eps * nrm, ring)
        if left == right:
            continue
        if left:
            kept.setdefault(ka, []).append((kb, a, b))
        else:
            kept.setdefault(kb, []).append((ka, b, a))

    rings_out: list[np.ndarray] = []
    used: set = set()
    for start_key in list(kept):
        for edge in kept[start_key]:
            if (start_key, edge[0]) in used:
                continue
            # trace a loop keeping the region on the left: at each head
            # vertex pick the unused outgoing edge making the sharpest
            # clockwise turn from the incoming reverse direction
            loop = [edge[1]]
            cur_key, cur_edge = start_key, edge
            ok = True
            for _ in range(len(noded) * 2 + 4):
                used.add((cur_key, cur_edge[0]))
                loop.append(cur_edge[2])
                head = cur_edge[0]
                if head == start_key and len(loop) > 2:
                    break
                outs = [e for e in kept.get(head, [])
                        if (head, e[0]) not in used]
                if not outs:
                    ok = False
                    break
                d_in = cur_edge[2] - cur_edge[1]
                ang_in = np.arctan2(d_in[1], d_in[0]) + np.pi  # reverse

                def turn(e):
                    d_out = e[2] - e[1]
                    ang = np.arctan2(d_out[1], d_out[0])
                    # angle CCW from reverse(in) to out, in (0, 2π]
                    t = (ang - ang_in) % (2 * np.pi)
                    return t if t > 1e-12 else 2 * np.pi

                cur_key, cur_edge = head, max(outs, key=turn)
            else:
                ok = False
            if ok and len(loop) > 3:
                r = np.asarray(loop[:-1], np.float64)
                if Polygon._ring_area(r) > 0:  # CCW → exterior
                    rings_out.append(r)
    return rings_out


# --------------------------------------------------------------------------
# Exact polygon-intersection area via the boundary integral
# ½∮(x dy − y dx): the boundary of A∩B is {pieces of ∂A inside B} ∪
# {pieces of ∂B inside A}, each traversed with its own orientation
# (exterior CCW, holes CW); a directed piece contributes cross(p0, p1)/2
# whatever the order pieces are visited in, so no clipped polygon is
# built. Pieces along the other boundary (shared edges) weigh ½ from each
# side, which sums to one count.
# --------------------------------------------------------------------------


def _oriented_rings(p: Polygon) -> list[np.ndarray]:
    """Rings of ``p`` with the orientation of ∂p as a region boundary:
    exterior CCW (positive shoelace), holes CW."""
    ext = p.exterior
    if Polygon._ring_area(ext) < 0:
        ext = ext[::-1]
    rings = [ext]
    for h in p.holes:
        if len(h) < 3:
            continue
        rings.append(h[::-1] if Polygon._ring_area(h) > 0 else h)
    return rings


def _on_boundary(pt: np.ndarray, rings: list[np.ndarray],
                 eps: float) -> bool:
    """True if ``pt`` lies within ``eps`` of any ring segment."""
    for ring in rings:
        a = ring
        e = np.roll(ring, -1, axis=0) - a
        w = pt[None, :] - a
        ee = (e * e).sum(1)
        t = np.clip(np.divide((w * e).sum(1), ee, out=np.zeros_like(ee),
                              where=ee > 0), 0.0, 1.0)
        close = a + t[:, None] * e
        if (((pt[None, :] - close) ** 2).sum(1) < eps * eps).any():
            return True
    return False


def _boundary_piece_sum(a: Polygon, b: Polygon, eps: float) -> float:
    """Σ shoelace contributions of the pieces of ∂a inside b (weight ½
    for pieces along ∂b)."""
    b_rings = [b.exterior, *b.holes]
    s = 0.0
    for ring in _oriented_rings(a):
        n = len(ring)
        for i in range(n):
            p0 = ring[i]
            p1 = ring[(i + 1) % n]
            ts = [np.array([0.0, 1.0])]
            for br in b_rings:
                ts.append(_segment_cross_params(p0, p1, br))
            t = np.unique(np.clip(np.concatenate(ts), 0.0, 1.0))
            d = p1 - p0
            for t0, t1 in zip(t[:-1], t[1:]):
                if t1 - t0 <= 1e-15:
                    continue
                mid = p0 + (0.5 * (t0 + t1)) * d
                if _on_boundary(mid, b_rings, eps):
                    w = 0.5
                elif b.contains_point(float(mid[0]), float(mid[1])):
                    w = 1.0
                else:
                    continue
                q0 = p0 + t0 * d
                q1 = p0 + t1 * d
                s += w * 0.5 * (q0[0] * q1[1] - q1[0] * q0[1])
    return s


def intersection_area(a: Polygon, b: Polygon) -> float:
    """Exact area of ``a ∩ b`` (concave polygons and holes too), as
    shapely's ``a.intersection(b).area`` gives it: the effective-area
    correction of the per-ROI densities."""
    ax0, ay0, ax1, ay1 = a.bounds
    bx0, by0, bx1, by1 = b.bounds
    if min(ax1, bx1) <= max(ax0, bx0) or min(ay1, by1) <= max(ay0, by0):
        return 0.0
    diag = max(ax1 - ax0, ay1 - ay0, bx1 - bx0, by1 - by0, 1.0)
    eps = 1e-9 * diag
    total = _boundary_piece_sum(a, b, eps) + _boundary_piece_sum(b, a, eps)
    return max(total, 0.0)
