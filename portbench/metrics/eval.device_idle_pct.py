"""The device's idle share of the traced window: 100 × (1 − the union of
every kernel, copy and memset interval on any stream, over the window).
None when the trace shows no device work."""

UNIT = "%"
LAYER = "device"
MOVES = "eval_images_per_s"
KERNELS = ()  # every device op


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
