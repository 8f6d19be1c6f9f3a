"""Seconds per image that ``ClassposeModel._eval_2d`` spends in its
copies of the style, flows, cell probability and class logits to the
host (``runner/model.py``), the first of which waits for the net: the
span ``image.readback`` over the traced window, over the images."""

UNIT = "s/image"
LAYER = "per-image runner (runner/core.py TileRunner, ClassposeModel.eval)"
MOVES = "eval_images_per_s"
KERNELS = ()
SPANS = ("image.readback",)


def read(ctx):
    if ctx["trace"] is None:
        return None
    n = ctx["result"]["counters"].get("images")
    if not n:
        return None
    try:
        from classpose_tpu_torch.tracing import profiled
    except ImportError:  # a program without spans
        return None
    spans = profiled()
    hits = [spans[k][0] for k in SPANS if k in spans]
    return sum(hits) / n if hits else None
