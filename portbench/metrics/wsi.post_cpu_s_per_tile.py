"""Host CPU-seconds of the polygon post-processing per slide tile: the
sum over the window's slides of ``stage_seconds["host_post"]`` that
``pipeline/predict_wsi.py`` ``main`` returns (its post pool's
``pipeline/postprocess.py`` contours, ring metrics and GeoJSON
features), over the tiles."""

UNIT = "s/tile"
LAYER = "postprocess (pipeline/postprocess.py in DeviceWorker's pool)"
MOVES = "slide_tiles_per_s"
KERNELS = ()


def read(ctx):
    c = ctx["result"]["counters"]
    if not c["tiles"]:
        return None
    return c["stage_seconds"]["host_post"] / c["tiles"]
