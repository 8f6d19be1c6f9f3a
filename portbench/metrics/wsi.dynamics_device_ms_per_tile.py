"""Device milliseconds of the dynamics' kernels per slide tile: the
bilinear sampler of the flow following (kernel 2), the landing-position
histogram (kernel 3) and the masked diffusion of the flow-error QC
(kernel 4: its pack and round kernels), from ``dynamics/``,
``ops/sample.py`` and ``ops/diffusion.py``."""

UNIT = "ms/tile"
LAYER = "dynamics kernels (dynamics/, ops/sample.py, ops/diffusion.py)"
MOVES = "slide_tiles_per_s"
KERNELS = ("bilinear_sample_kernel", "landing_histogram_kernel",
           "pack_kernel", "round_kernel")


def read(ctx):
    tr, res = ctx["trace"], ctx["result"]
    t = None if tr is None else tr.seconds(KERNELS)
    if not t or not res["counters"]["tiles"]:
        return None
    return 1e3 * t / res["counters"]["tiles"]
