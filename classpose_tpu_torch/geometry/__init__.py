"""Host-side computational geometry (counterpart of
``classpose_tpu/geometry``): shoelace metrics, ray-casting containment,
segment-intersection validity and exact repair, an STR-packed R-tree, and
centroid deduplication, on the native core in ``native/geomfast.cpp``."""

from classpose_tpu_torch.geometry.dedup import deduplicate
from classpose_tpu_torch.geometry.polygons import Polygon, make_valid
from classpose_tpu_torch.geometry.strtree import STRtree

__all__ = ["Polygon", "make_valid", "STRtree", "deduplicate"]
