"""Seconds per slide tile that the main thread waited for the next tile
from the reader threads: the span ``wsi.read_wait`` around
``SlideLoader.stream``'s queue get (``pipeline/slide_loader.py``) over
the traced window, over the tiles."""

UNIT = "s/tile"
LAYER = "slide I/O (pipeline/slide_loader.py, io/array_reader.py)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("wsi.read_wait",)


def read(ctx):
    if ctx["trace"] is None:
        return None
    n = ctx["result"]["counters"].get("tiles")
    if not n:
        return None
    try:
        from classpose_tpu_torch.tracing import profiled
    except ImportError:  # a program without spans
        return None
    spans = profiled()
    hits = [spans[k][0] for k in SPANS if k in spans]
    return sum(hits) / n if hits else None
