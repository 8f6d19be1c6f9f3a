"""Kernel 1's share of its roofline (``csrc/attention.cu``, bf16, through
``nn/attention.py`` ``attention_relpos``): the least time the chip needs
for the window's attention calls, over the device time of the kernels
named here. Per layer call over B crops of L = 32² tokens, width E =
n·hd: 4·B·L²·E FLOPs (QKᵀ and PV), and bytes read once and written once:
qkv (3E), the bias columns (n·(H + W)) and the output (E) per token, in
bf16. The bound is the larger of FLOPs at 989 TFLOP/s and bytes at
3.35 TB/s."""

from portbench.harness.flops import bound_s

UNIT = "%"
LAYER = "attention kernels (nn/attention.py, csrc/attention.cu)"
MOVES = "slide_tiles_per_s"
KERNELS = ("attn_fwd_kernel",)
ITEMSIZE = 2
PRECISION = "bf16"


def attention_work(crops: int, m: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of every layer's attention over ``crops`` crops."""
    g = m["bsize"] // m["ps"]
    L, E = g * g, m["embed_dim"]
    flops = 4.0 * crops * L * L * E
    nbytes = crops * L * (4 * E + m["num_heads"] * 2 * g) * ITEMSIZE
    return m["depth"] * flops, m["depth"] * nbytes


def read(ctx):
    tr, res, cell = ctx["trace"], ctx["result"], ctx["cell"]
    t = None if tr is None else tr.seconds(KERNELS)
    if not t:
        return None
    flops, nbytes = attention_work(res["counters"]["crops"],
                                   cell.config["model"])
    return 100.0 * bound_s(flops, nbytes, PRECISION) / t
