"""Operation counts and the chip's peaks: the yardstick of the MFU and
roofline readers.

``vit_forward_flops`` is the forward half of ``chip_smoke.py``
``vit_train_flops_per_image`` (which repeats ``tools/bench_train.py``'s
count): the matrix-product FLOPs of one bsize² crop through the patch
embed, the blocks (qkv, proj, the two attention products, the MLP), the
neck and both heads; training counts three times the forward.
``bound_s`` is the formula behind ``chip_smoke.py`` ``attention_rates``
and ``bound_ms``: the least time the chip could take, the larger of
operations over the peak rate and bytes over the memory bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: FLOP/s by arithmetic, bytes/s of HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12


def vit_forward_flops(m: dict) -> float:
    """Matrix-product FLOPs of one bsize² crop's forward."""
    L = (m["bsize"] // m["ps"]) ** 2
    E, ps, D = m["embed_dim"], m["ps"], m["neck_dim"]
    per_tok = 3 * E * E * 2 + E * E * 2 + 2 * E * E * m["mlp_ratio"] * 2
    attn = 2 * L * L * E * 2
    blocks = m["depth"] * (L * per_tok + attn)
    patch = L * (3 * ps * ps) * E * 2
    neck = L * (E * D + 9 * D * D) * 2
    heads = L * D * (m["nout"] + m["n_cell_classes"]) * ps * ps * 2
    return float(blocks + patch + neck + heads)


def vit_train_flops(m: dict) -> float:
    return 3.0 * vit_forward_flops(m)


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The roofline's least time for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)

