"""Cross-tile cell deduplication (counterpart of
``classpose_tpu/geometry/dedup.py``, native path).

Pair all cell centroids closer than ``max_dist`` (default 7.5 px), union
the pairs into groups with the reference's first-come assignment over
pairs in sorted (a, b) order, and keep only the largest cell of each
group. The grid-hash pair search and the greedy grouping run in
``native/geomfast.cpp`` ``dedup_keep``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.native import load_geomfast

logger = get_logger(__name__)


def _centers_sizes(features: list[dict]):
    """(n, 2) float64 centres + (n,) sizes from the measurement lists.

    The fast path indexes the fixed [area, perimeter, centroidX,
    centroidY] layout of ``to_geojson_polygon``; any other feature falls
    back to a name scan (external GeoJSON input)."""
    n = len(features)
    centers = np.empty((n, 2), np.float64)
    sizes = np.empty(n, np.float64)
    for i, feature in enumerate(features):
        ms = feature["properties"]["measurements"]
        if (len(ms) == 4 and ms[0]["name"] == "area"
                and ms[2]["name"] == "centroidX"
                and ms[3]["name"] == "centroidY"):
            sizes[i] = ms[0]["value"]
            centers[i, 0] = ms[2]["value"]
            centers[i, 1] = ms[3]["value"]
        else:
            by_name = {m["name"]: m["value"] for m in ms}
            sizes[i] = by_name["area"]
            centers[i, 0] = by_name["centroidX"]
            centers[i, 1] = by_name["centroidY"]
    return centers, sizes


def _keep_mask(centers: np.ndarray, sizes: np.ndarray,
               max_dist: float) -> np.ndarray:
    D = ctypes.POINTER(ctypes.c_double)
    c = np.ascontiguousarray(centers, np.float64)
    s = np.ascontiguousarray(sizes, np.float64)
    keep = np.empty(len(c), np.uint8)
    load_geomfast().dedup_keep(
        c.ctypes.data_as(D), s.ctypes.data_as(D), len(c), float(max_dist),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return keep.astype(bool)


def deduplicate(features: list[dict], max_dist: float = 15 / 2) -> list[dict]:
    """Deduplicate GeoJSON cell features by centroid distance, keeping
    the largest area in each near-duplicate group."""
    if not features:
        return features
    centers, sizes = _centers_sizes(features)
    keep = _keep_mask(centers, sizes, max_dist)
    output = [f for f, k in zip(features, keep) if k]
    logger.info(f"Removed {len(features) - len(output)} duplicates.")
    logger.info(f"Number of cells: {len(output)}")
    return output
