"""The model step's share of the chip's peak over the traced window: the
forward's matrix-product FLOPs of every 256² crop the window ran
(``vit_forward_flops``: patch embed, 24 blocks, neck, heads), over the
window's length times the fp32 peak of 67 TFLOP/s (without the tensor
cores)."""

from portbench.harness.flops import PEAK_FLOPS, vit_forward_flops

UNIT = "%"
LAYER = "per-image runner (runner/core.py TileRunner, ClassposeModel.eval)"
MOVES = "eval_images_per_s"
KERNELS = ()  # counts work, not kernels


def read(ctx):
    tr, res, cell = ctx["trace"], ctx["result"], ctx["cell"]
    if tr is None or tr.busy_s <= 0:
        return None
    flops = res["counters"]["crops"] * vit_forward_flops(cell.config["model"])
    return 100.0 * flops / (tr.window_s * PEAK_FLOPS[cell.config["precision"]])
