"""Inference-thread seconds per slide tile in ``eval_batch``'s copies of
the labels and class map to the host (``runner/model.py``), which wait
for the batch's device program: the span ``batch.readback`` over the
traced window, over the tiles."""

UNIT = "s/tile"
LAYER = "model step (runner/model.py _device_program)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("batch.readback",)


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
