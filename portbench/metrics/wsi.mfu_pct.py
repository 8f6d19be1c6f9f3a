"""The model step's share of the chip's peak over the traced window: the
forward's matrix-product FLOPs of every 256² crop the window ran
(``vit_forward_flops``: patch embed, 24 blocks, neck, heads), over the
window's length times the bf16 peak of 989 TFLOP/s."""

from portbench.harness.flops import PEAK_FLOPS, vit_forward_flops

UNIT = "%"
LAYER = "model step (runner/model.py _device_program)"
MOVES = "slide_tiles_per_s"
KERNELS = ()  # counts work, not kernels


def read(ctx):
    tr, res, cell = ctx["trace"], ctx["result"], ctx["cell"]
    if tr is None or tr.busy_s <= 0:
        return None
    flops = res["counters"]["crops"] * vit_forward_flops(cell.config["model"])
    return 100.0 * flops / (tr.window_s * PEAK_FLOPS[cell.config["precision"]])
