"""Kernel-vs-plain checks that need the card (marker ``cuda``): each CUDA
kernel of the port against its plain PyTorch version on the same inputs.
They skip without a CUDA device; ``chip_smoke.py`` runs the same checks
at the main path's shapes."""

import numpy as np
import pytest
import torch

from classpose_tpu_torch import _build
from classpose_tpu_torch.nn.attention import (
    attention_relpos,
    attention_relpos_plain,
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
