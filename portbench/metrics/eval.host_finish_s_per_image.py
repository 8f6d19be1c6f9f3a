"""Seconds per image of ``ClassposeModel._eval_2d``'s finish after the
readback (``runner/model.py``): ``dynamics/masks.py`` ``compute_masks``
(the spans ``masks.*``: flow following, labels, max-size filter, QC,
holes), the class vote and ``dx_to_circ``; the spans ``image.masks``,
``image.vote`` and ``image.circ`` over the traced window, over the
images. It includes the dynamics' short device work (kernels 2, 3 and
7) and the host's waits for it."""

UNIT = "s/image"
LAYER = "per-image runner (runner/core.py TileRunner, ClassposeModel.eval)"
MOVES = "eval_images_per_s"
KERNELS = ()
SPANS = ("image.masks", "image.vote", "image.circ")


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
