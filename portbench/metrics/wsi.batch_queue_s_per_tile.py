"""Seconds per slide tile that a dealt batch waited for an inference
thread: the counter ``wsi.batch_queue`` that ``DeviceWorker._run_batch``
(``pipeline/predict_wsi.py``) adds at its start, each batch's seconds
from its flush to that start times its tiles, over the traced window,
over the tiles."""

UNIT = "s/tile"
LAYER = "model step (runner/model.py _device_program)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("wsi.batch_queue",)


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
