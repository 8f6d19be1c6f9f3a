"""STR-packed R-tree over polygon bounding boxes (counterpart of
``classpose_tpu/geometry/strtree.py``): bulk-load the polygons once,
query candidate polygons by bbox, then confirm with exact point-in-polygon
tests. Used for ROI/tissue cell filtering and tile pre-filters.
"""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.geometry.polygons import Polygon


class STRtree:
    """Sort-Tile-Recursive packed R-tree (static, bulk-loaded)."""

    def __init__(self, geoms: list[Polygon], node_capacity: int = 16):
        self.geoms = list(geoms)
        self._cap = node_capacity
        n = len(self.geoms)
        if n == 0:
            self._levels = []
            return
        boxes = np.array([g.bounds for g in self.geoms], np.float64)
        idx = np.arange(n)
        # STR packing: sort by cx, slice into vertical strips, sort each by cy
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        order = np.argsort(cx, kind="stable")
        s = int(np.ceil(np.sqrt(np.ceil(n / node_capacity))))
        strip = int(np.ceil(n / s))
        leaf_order = []
        for i in range(0, n, strip):
            part = order[i : i + strip]
            leaf_order.extend(part[np.argsort(cy[part], kind="stable")])
        leaf_order = np.array(leaf_order)

        # build level 0 = leaves (groups of indices), then upper levels of
        # bounding boxes
        self._leaf_groups = [
            leaf_order[i : i + node_capacity]
            for i in range(0, n, node_capacity)
        ]
        self._leaf_boxes = np.array(
            [
                [
                    boxes[g, 0].min(), boxes[g, 1].min(),
                    boxes[g, 2].max(), boxes[g, 3].max(),
                ]
                for g in self._leaf_groups
            ]
        )
        self._boxes = boxes

    def query_bbox(self, bbox) -> np.ndarray:
        """Indices of geometries whose bbox intersects ``bbox``
        (minx, miny, maxx, maxy)."""
        if not self.geoms:
            return np.array([], int)
        minx, miny, maxx, maxy = bbox
        lb = self._leaf_boxes
        hit_leaves = np.nonzero(
            (lb[:, 0] <= maxx) & (lb[:, 2] >= minx)
            & (lb[:, 1] <= maxy) & (lb[:, 3] >= miny)
        )[0]
        out = []
        for li in hit_leaves:
            g = self._leaf_groups[li]
            b = self._boxes[g]
            m = (
                (b[:, 0] <= maxx) & (b[:, 2] >= minx)
                & (b[:, 1] <= maxy) & (b[:, 3] >= miny)
            )
            out.append(g[m])
        return np.concatenate(out) if out else np.array([], int)

    def query_point(self, x: float, y: float) -> np.ndarray:
        return self.query_bbox((x, y, x, y))

    def contains_points(self, pts: np.ndarray) -> np.ndarray:
        """For (N, 2) points, return a bool mask: point inside ANY indexed
        polygon (the reference's centroid-"within" filter)."""
        pts = np.asarray(pts, np.float64)
        out = np.zeros(len(pts), bool)
        if not self.geoms or len(pts) == 0:
            return out
        # bucket points by leaf bbox to limit exact tests
        for li, g in enumerate(self._leaf_groups):
            lb = self._leaf_boxes[li]
            cand = (
                (pts[:, 0] >= lb[0]) & (pts[:, 0] <= lb[2])
                & (pts[:, 1] >= lb[1]) & (pts[:, 1] <= lb[3])
                & ~out
            )
            if not cand.any():
                continue
            sub = np.nonzero(cand)[0]
            for gi in g:
                geom = self.geoms[gi]
                b = self._boxes[gi]
                m = (
                    (pts[sub, 0] >= b[0]) & (pts[sub, 0] <= b[2])
                    & (pts[sub, 1] >= b[1]) & (pts[sub, 1] <= b[3])
                )
                if not m.any():
                    continue
                test = sub[m]
                inside = geom.contains_points(pts[test])
                out[test[inside]] = True
                sub = sub[~np.isin(sub, test[inside])]
                if len(sub) == 0:
                    break
        return out

    def intersects_bbox(self, bbox) -> bool:
        """True if any geometry's bbox overlaps AND the bbox corners/center
        or polygon vertices indicate a real overlap. Used for tile
        pre-filtering; bbox-level precision is what the reference
        effectively gets for coarse tissue tiles."""
        cand = self.query_bbox(bbox)
        if len(cand) == 0:
            return False
        minx, miny, maxx, maxy = bbox
        corners = np.array(
            [
                [minx, miny], [minx, maxy], [maxx, miny], [maxx, maxy],
                [(minx + maxx) / 2, (miny + maxy) / 2],
            ]
        )
        for gi in cand:
            g = self.geoms[gi]
            if g.contains_points(corners).any():
                return True
            e = g.exterior
            m = (
                (e[:, 0] >= minx) & (e[:, 0] <= maxx)
                & (e[:, 1] >= miny) & (e[:, 1] <= maxy)
            )
            if m.any():
                return True
        return False
