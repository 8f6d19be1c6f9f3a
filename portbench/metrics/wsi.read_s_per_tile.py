"""Reader-thread seconds per slide tile of the slide loader's reads and
resizes: the spans ``wsi.read`` (``read_region`` and the pixels out of
it) and ``wsi.resize`` (``resize_linear_u8`` to the model's MPP) that
``pipeline/slide_loader.py`` ``SlideLoader.stream``'s reader threads
record over the traced window, over the tiles. The readers run beside
the main thread, so this is work, not a wait: ``wsi.read_wait_s_per_tile``
says how much of it the pipeline waited for."""

UNIT = "s/tile"
LAYER = "slide I/O (pipeline/slide_loader.py, io/array_reader.py)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("wsi.read", "wsi.resize")


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
