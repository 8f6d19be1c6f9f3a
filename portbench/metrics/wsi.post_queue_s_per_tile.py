"""Seconds per slide tile that a tile's polygon job waited for a thread
of ``DeviceWorker``'s post pool: the counter ``wsi.post_queue``, each
job's seconds from its submission to its start
(``pipeline/predict_wsi.py``), over the traced window, over the
tiles."""

UNIT = "s/tile"
LAYER = "postprocess (pipeline/postprocess.py in DeviceWorker's pool)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("wsi.post_queue",)


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
