"""Kernel-vs-plain checks that need the card (marker ``cuda``): each CUDA
kernel of the port against its plain PyTorch version on the same inputs.
They skip without a CUDA device; ``chip_smoke.py`` runs the same checks
at the main path's shapes."""

import json

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
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from classpose_tpu_torch.nn.layernorm import (
    layernorm,
    layernorm_cuda,
    layernorm_ref,
)
from classpose_tpu_torch.ops.diffusion import (
    diffuse_blocked,
    diffuse_blocked_plain,
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


@pytest.mark.parametrize("shape,k", [((3, 48, 80), 1), ((2, 130, 70), 40),
                                     ((1, 200, 333), 8)])
def test_diffuse_blocked_kernel(dev, shape, k):
    """Kernel 7 against its plain version, bitwise: a nonzero T0, raw
    labels, counts that are not multiples of k or of the kernel's 8
    iterations per launch, a tile with no iteration, ragged 64² blocks."""
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(
        (rng.integers(0, 5, size=shape) * 977).astype(np.int32)).to(dev)
    cen = torch.from_numpy(
        (rng.uniform(size=shape) < 0.05).astype(np.float32)).to(dev)
    T0 = torch.from_numpy(rng.uniform(0, 2, size=shape).astype(
        np.float32)).to(dev)
    niters = torch.from_numpy(
        np.array([50, 0, 13][:shape[0]], np.int32)).to(dev)
    before = _build.LAUNCHES["diffuse_blocked"]
    got = diffuse_blocked(T0, ids, cen, niters, k=k)
    assert _build.LAUNCHES["diffuse_blocked"] > before
    assert torch.equal(got, diffuse_blocked_plain(T0, ids, cen, niters, k=k))


@pytest.mark.parametrize("dtype,G", [(torch.float32, 8), (torch.float32, 16),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 32)])
def test_flash_attention_relpos_kernel(dev, dtype, G):
    """Kernel 8 against its plain version: fp32 products on the CUDA
    cores, sums in another order, |Δ| ≤ 1e-4 + 1e-4·|ref|; bf16 as kernel
    1, 2e-2; its route raises where a gradient would flow."""
    g = torch.Generator(device="cpu").manual_seed(G)
    B, n, hd, L = 2, 3, 64, G * G
    q, k, v = (torch.randn(B, n, L, hd, generator=g).to(dev, dtype)
               for _ in range(3))
    rh, rw = ((2 * torch.randn(B, n, L, G, generator=g)).to(dev, dtype)
              for _ in range(2))
    before = _build.LAUNCHES["flash_attention_relpos"]
    got = flash_attention_relpos(q, k, v, rh, rw, hd ** -0.5, (G, G))
    assert _build.LAUNCHES["flash_attention_relpos"] == before + 1
    ref = flash_attention_relpos_plain(q, k, v, rh, rw, hd ** -0.5)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_relpos(q.requires_grad_(), k, v, rh, rw, 0.125,
                               (G, G))


@pytest.mark.parametrize("shape,fast_var", [((3, 50, 1024), True),
                                            ((2, 8, 8, 256), False),
                                            ((7, 128), True),
                                            ((5, 384), False),
                                            ((2, 2048), True)])
def test_layernorm_kernel(dev, shape, fast_var):
    """Kernel 6 against its plain version: bf16 outputs of fp32 math
    summed in another order, |Δ| ≤ 0.06 + 0.02·|ref| (the JAX kernel
    test's tolerance)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    C = shape[-1]
    x = (torch.randn(shape, generator=g) * 3 + 0.5).to(dev, torch.bfloat16)
    w, b = (torch.randn(C, generator=g).to(dev) for _ in range(2))
    before = _build.LAUNCHES["layernorm"]
    got = layernorm_cuda(x, w, b, 1e-6, fast_var)
    assert _build.LAUNCHES["layernorm"] == before + 1
    ref = layernorm_ref(x, w, b, 1e-6, fast_var)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert bool(((got.float() - ref.float()).abs()
                 <= 0.06 + 0.02 * ref.float().abs()).all())


def test_layernorm_switch_on_card(dev, monkeypatch):
    """With the switch on, a supported CUDA tensor launches the kernel;
    off, the plain version runs; a tensor that needs a gradient raises on
    the kernel route instead of returning one without ``grad_fn``."""
    x = torch.randn(4, 16, 256, device=dev).to(torch.bfloat16)
    w, b = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    monkeypatch.setenv("CLASSPOSE_LN_PALLAS", "0")
    before = _build.LAUNCHES["layernorm"]
    assert torch.equal(layernorm(x, w, b), layernorm_ref(x, w, b))
    assert _build.LAUNCHES["layernorm"] == before
    monkeypatch.setenv("CLASSPOSE_LN_PALLAS", "1")
    layernorm(x, w, b)
    assert _build.LAUNCHES["layernorm"] == before + 1
    with pytest.raises(RuntimeError, match="no backward"):
        layernorm(x.requires_grad_(), w, b)
    with torch.no_grad():
        layernorm(x, w.requires_grad_(), b)
    assert _build.LAUNCHES["layernorm"] == before + 2


def test_wsi_pipeline_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """The WSI CLI at a tiny fp32 size on the card (two inference threads
    on their own streams, pinned uploads) finds the cells the CPU run
    finds: counts within 0.5%, ≥ 99% of centroids within 1 px."""
    from scipy.spatial import cKDTree

    from classpose_tpu_torch.entrypoints.predict_wsi import main_with_args
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.nn.convert import save_params
    from classpose_tpu_torch.nn.synthetic import perturbed_structured_params
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig

    monkeypatch.setenv("WSI_READER", "array")
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    np.save(tmp_path / "slide.npy", slide._level0)
    # head width 64: at fp32 the card's attention is kernel 8
    cfg = ClassTransformerConfig(n_cell_classes=4, ps=4, embed_dim=128,
                                 depth=2, num_heads=2, neck_dim=64, bsize=64)
    save_params(perturbed_structured_params(cfg, attn_ripple=0.5),
                str(tmp_path / "m.npz"), cfg)
    (tmp_path / "c.yaml").write_text(
        f"path: {tmp_path}/m.npz\nmpp: 0.5\ncell_types: [A, B, C, D]\n")
    pts = {}
    for device in ("cpu", "cuda"):
        res = main_with_args([
            "--model_config", str(tmp_path / "c.yaml"), "--slide_path",
            str(tmp_path / "slide.npy"), "--output_folder",
            str(tmp_path / device), "--device", device, "--precision",
            "fp32", "--tile_size", "256", "--mpp", "0.4",
            "--tile_batch", "3"])[0]
        feats = json.loads((tmp_path / device /
                            "slide_cell_centroids.geojson").read_text())
        pts[device] = np.array([f["geometry"]["coordinates"]
                                for f in feats["features"]])
        assert len(pts[device]) == res["n_cells"] > 50
    assert abs(len(pts["cuda"]) - len(pts["cpu"])) <= 0.005 * len(pts["cpu"])
    dist, _ = cKDTree(pts["cpu"]).query(pts["cuda"],
                                        distance_upper_bound=1.0)
    assert np.isfinite(dist).mean() >= 0.99
