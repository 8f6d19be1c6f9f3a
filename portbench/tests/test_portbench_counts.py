"""Operation and byte counts against hand counts at the cells' shapes."""

import pytest

from portbench import run
from portbench.harness import flops

VITL = run.config_file("classpose-vitl-conic-bf16")["model"]


def test_vit_forward_flops_by_hand():
    # one 256² crop: 1024 tokens of width 1024, 24 blocks, neck 256
    L, E = 1024, 1024
    qkv, proj, mlp = 2 * L * E * 3 * E, 2 * L * E * E, 2 * 2 * L * E * 4 * E
    attn = 2 * 2 * L * L * E
    blocks = 24 * (qkv + proj + mlp + attn)
    patch = 2 * L * 192 * E
    neck = 2 * L * (E * 256 + 9 * 256 * 256)
    heads = 2 * L * 256 * (3 + 6) * 64
    assert flops.vit_forward_flops(VITL) == blocks + patch + neck + heads
    assert flops.vit_forward_flops(VITL) == pytest.approx(0.7240e12,
                                                          rel=1e-3)
    assert flops.vit_train_flops(VITL) == 3 * flops.vit_forward_flops(VITL)


@pytest.mark.parametrize("metric,itemsize,precision", [
    ("wsi.attn_bf16_roofline", 2, "bf16"),
    ("eval.attn_fp32_roofline", 4, "fp32")])
def test_attention_counts_by_hand(metric, itemsize, precision):
    mod = run.load_module(run.BENCH / "metrics" / f"{metric}.py")
    f, b = mod.attention_work(25, VITL)
    # 25 crops × 24 layers: 4·L²·E FLOPs; q, k, v, out and 16 heads ×
    # (32 + 32) bias columns per token
    assert f == 24 * 25 * 4 * 1024 ** 2 * 1024
    assert b == 24 * 25 * 1024 * (4 * 1024 + 16 * 64) * itemsize
    assert mod.ITEMSIZE == itemsize and mod.PRECISION == precision
    # bf16: bound by operations (25 crops, one layer: 0.1086 ms)
    one = flops.bound_s(f / 24, b / 24, precision)
    assert one == pytest.approx(f / 24 / flops.PEAK_FLOPS[precision])


def test_bound_takes_the_larger_side():
    assert flops.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert flops.bound_s(67e12, 6.7e12, "fp32") == pytest.approx(2.0)


def test_mfu_reader():
    mod = run.load_module(run.BENCH / "metrics" / "wsi.mfu_pct.py")

    class T:
        busy_s, window_s = 1.0, 10.0

    class C:
        config = {"model": VITL, "precision": "bf16"}

    crops = 1000
    got = mod.read(dict(trace=T, result={"counters": {"crops": crops}},
                        cell=C))
    want = 100 * crops * flops.vit_forward_flops(VITL) / (10 * 989e12)
    assert got == pytest.approx(want)
