"""Seconds of the single-threaded tail per slide tile: the sum over the
window's slides of ``stage_seconds["dedup"] + stage_seconds["export"]``
that ``pipeline/predict_wsi.py`` ``main`` returns (``geometry/dedup.py``,
then ``pipeline/outputs.py``: GeoJSON, densities CSV, SpatialData zarr),
over the tiles."""

UNIT = "s/tile"
LAYER = "dedup and outputs (geometry/dedup.py, pipeline/outputs.py)"
MOVES = "slide_tiles_per_s"
KERNELS = ()


def read(ctx):
    c = ctx["result"]["counters"]
    if not c["tiles"]:
        return None
    s = c["stage_seconds"]
    return (s["dedup"] + s["export"]) / c["tiles"]
