"""Inference-thread seconds per slide tile of ``eval_batch``'s host
finish after the readback (``runner/model.py``): densify, holes, small
masks and the class vote; the span ``batch.finish`` over the traced
window, over the tiles."""

UNIT = "s/tile"
LAYER = "model step (runner/model.py _device_program)"
MOVES = "slide_tiles_per_s"
KERNELS = ()
SPANS = ("batch.finish",)


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
