"""Kernel-vs-plain checks that need the card (marker ``cuda``): each CUDA
kernel of the port against its plain PyTorch version on the same inputs.
They skip without a CUDA device; ``chip_smoke.py`` runs the same checks
at the main path's shapes."""

import numpy as np
import pytest
import torch

from classpose_tpu_torch import _build
import classpose_tpu_torch.nn.vit_sam as port_vit
from classpose_tpu_torch.nn.attention import (
    _fwd_kernel,
    attention_relpos,
    attention_relpos_bwd,
    attention_relpos_bwd_plain,
    attention_relpos_plain,
    attention_relpos_plain_route,
)
from classpose_tpu_torch.ops.diffusion import (
    masked_diffusion,
    masked_diffusion_plain,
)
from classpose_tpu_torch.ops.sample import (
    bilinear_sample,
    bilinear_sample_plain,
    landing_histogram,
    landing_histogram_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_attention_kernel(dev):
    g = torch.Generator(device="cpu").manual_seed(0)
    B, n, H, W, hd = 2, 4, 16, 16, 64
    qkv = torch.randn(B, H * W, 3 * n * hd, generator=g).to(dev, torch.bfloat16)
    rel = (2 * torch.randn(B, H * W, n, H + W, generator=g)).to(
        dev, torch.bfloat16)
    before = _build.LAUNCHES["attention_fwd"]
    got = attention_relpos(qkv, rel, hd ** -0.5, (H, W), n)
    assert _build.LAUNCHES["attention_fwd"] == before + 1
    ref = attention_relpos_plain(qkv, rel, hd ** -0.5, (H, W), n)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("B,n,G", [(1, 2, 8), (2, 4, 16), (1, 2, 32)])
def test_attention_bwd_kernel(dev, B, n, G):
    """Kernel 5 against the plain vjp: bf16 outputs of bf16 products with
    fp32 sums (p and ds rounded to bf16 before their products, as on the
    TPU), so |Δ| ≤ 2e-2·max|ref| + 2e-2·|ref|; the forward's output is
    the same bit for bit with and without the backward's statistics, and
    its f32 copy rounds to it."""
    g = torch.Generator(device="cpu").manual_seed(B * 100 + G)
    hd, L = 64, G * G
    qkv = torch.randn(B, L, 3 * n * hd, generator=g).to(dev, torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=g).to(dev, torch.bfloat16)
    dout = torch.randn(B, L, n * hd, generator=g).to(dev, torch.bfloat16)
    scale = hd ** -0.5
    out, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)
    assert torch.equal(out, _fwd_kernel(qkv, rel, scale, (G, G), n,
                                        False)[0])
    assert torch.equal(out32.bfloat16(), out)
    before = _build.LAUNCHES["attention_bwd"]
    got = attention_relpos_bwd(qkv, rel, out32, lse, dout, scale, (G, G), n)
    assert _build.LAUNCHES["attention_bwd"] == before + 1
    again = attention_relpos_bwd(qkv, rel, out32, lse, dout, scale, (G, G),
                                 n)
    ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (G, G), n)
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)  # no atomics: deterministic
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= 2e-2 * r.abs().max()
                     + 2e-2 * r.abs()).all())


def test_block_bf16_gradients_on_card(dev, monkeypatch):
    """A bf16 block on the card gives the attention's parameters non-zero
    gradients through the kernels, and they point where the plain route's
    do (cosine ≥ 0.99)."""
    torch.manual_seed(0)
    blk = port_vit.Block(256, 4, 4.0, (16, 16)).to(dev)
    with torch.no_grad():
        blk.attn.rel_pos_h.normal_(0, 0.5)
        blk.attn.rel_pos_w.normal_(0, 0.5)
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(2, 16, 16, 256, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(2, 16, 16, 256, generator=g).to(dev, torch.bfloat16)

    def grads():
        blk.zero_grad(set_to_none=True)
        (blk(x).float() * w.float()).sum().backward()
        return {k: p.grad.float().clone() for k, p in blk.named_parameters()}

    before = _build.LAUNCHES["attention_bwd"]
    got = grads()
    assert _build.LAUNCHES["attention_bwd"] == before + 1
    monkeypatch.setattr(port_vit, "attention_relpos",
                        attention_relpos_plain_route)
    ref = grads()
    for k in ("attn.qkv.weight", "attn.qkv.bias", "norm1.weight",
              "attn.rel_pos_h", "attn.rel_pos_w"):
        a, r = got[k].flatten(), ref[k].flatten()
        assert bool(torch.isfinite(a).all()) and float(a.norm()) > 0, k
        assert float(torch.nn.functional.cosine_similarity(a, r, 0)) >= 0.99


def test_sampler_and_histogram_kernels(dev):
    rng = np.random.default_rng(0)
    B, C, H, W = 2, 2, 64, 96
    u = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(np.float32))
    gy = torch.arange(H, dtype=torch.float32)[:, None].expand(B, H, W)
    gx = torch.arange(W, dtype=torch.float32)[None, :].expand(B, H, W)
    py = torch.clamp(gy + torch.from_numpy(
        rng.uniform(-9, 9, (B, H, W)).astype(np.float32)), 0, H - 1)
    px = torch.clamp(gx + torch.from_numpy(
        rng.uniform(-9, 9, (B, H, W)).astype(np.float32)), 0, W - 1)
    args = [t.contiguous().to(dev) for t in (u, py, px)]
    assert torch.equal(bilinear_sample(*args), bilinear_sample_plain(*args))
    fy, fx = torch.round(args[1]).int(), torch.round(args[2]).int()
    cell = (torch.rand(B, H, W) < 0.7).float().to(dev)
    assert torch.equal(landing_histogram(fy, fx, cell),
                       landing_histogram_plain(fy, fx, cell))


def test_diffusion_kernel(dev):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(
        rng.integers(0, 4, size=(3, 48, 80)).astype(np.int32)).to(dev)
    cen = torch.from_numpy(
        (rng.uniform(size=(3, 48, 80)) < 0.05).astype(np.float32)).to(dev)
    niter = torch.tensor([3, 11, 20], dtype=torch.int32, device=dev)
    assert torch.equal(masked_diffusion(ids, cen, niter),
                       masked_diffusion_plain(ids, cen, niter))
