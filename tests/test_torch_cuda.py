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
    diffusion_plan,
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


@pytest.mark.parametrize("B,n,H,W", [(1, 2, 8, 8), (2, 4, 16, 16),
                                     (2, 3, 32, 32), (1, 16, 32, 32),
                                     (2, 2, 8, 24), (1, 3, 24, 8),
                                     (40, 4, 8, 8), (12, 6, 8, 24),
                                     (2, 2, 28, 28), (1, 2, 64, 64),
                                     (2, 3, 12, 20), (2, 2, 8, 128),
                                     (2, 2, 2, 254), (1, 2, 128, 128)])
def test_attention_kernel(dev, B, n, H, W):
    """Kernel 1 against its plain version: bf16 output, |Δ| ≤ 2e-2 +
    2e-2·|ref|; its row log-sum-exp against the plain fp32 logits'
    (|Δ| ≤ 1e-3 + 1e-4·|lse|) and its fp32 output against the plain fp32
    softmax product (1e-2 + 1e-2·|ref|: p is rounded to bf16 before the
    product). L = 64 (one key block, masked past L), an odd head count,
    one wave short of the card's 132 SMs (1 × 16 heads × 1024 / 128), two
    non-square grids (W = 24 reads rel_w from shared memory), and more
    tiles than SMs at L = 64 and L = 192 (a CTA takes several tiles, its
    k/v ring and q buffers running on across them); the grids of bsize
    224 and 512 at patch 8 (28 x 28, L % 128 != 0; 64 x 64, H + W = 128)
    and 12 x 20 take the generic instantiation; past H + W = 128 (8 x 128,
    2 x 254, and 128 x 128 of bsize 1024) it stages each tile's bias rows
    in one buffer."""
    g = torch.Generator(device="cpu").manual_seed(B * 100 + H + W)
    hd, L = 64, H * W
    scale = hd ** -0.5
    qkv = torch.randn(B, L, 3 * n * hd, generator=g).to(dev, torch.bfloat16)
    rel = (2 * torch.randn(B, L, n, H + W, generator=g)).to(
        dev, torch.bfloat16)
    before = _build.LAUNCHES["attention_fwd"]
    got = attention_relpos(qkv, rel, scale, (H, W), n)
    assert _build.LAUNCHES["attention_fwd"] == before + 1
    ref = attention_relpos_plain(qkv, rel, scale, (H, W), n)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    out, lse, out32 = _fwd_kernel(qkv, rel, scale, (H, W), n, True)
    assert torch.equal(out, got)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].float()
               .reshape(B, L, n, hd).transpose(1, 2) for i in range(3))
    bias = (rel[..., :H].float().transpose(1, 2)[..., :, None]
            + rel[..., H:].float().transpose(1, 2)[..., None, :]
            ).reshape(B, n, L, L)
    s = q @ k.transpose(-1, -2) * scale + bias
    lse_ref = torch.logsumexp(s, -1)
    assert bool(((lse - lse_ref).abs() <= 1e-3 + 1e-4 * lse_ref.abs()).all())
    o_ref = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, n * hd)
    assert bool(((out32 - o_ref).abs() <= 1e-2 + 1e-2 * o_ref.abs()).all())


@pytest.mark.parametrize("B,n,G", [(1, 2, 8), (2, 4, 16), (1, 2, 32),
                                   (2, 2, 28), (1, 2, 64), (2, 3, (12, 20)),
                                   (2, 2, (8, 128)), (1, 2, (2, 254)),
                                   (1, 1, 128)])
def test_attention_bwd_kernel(dev, B, n, G):
    """Kernel 5 against the plain vjp: bf16 outputs of bf16 products with
    fp32 sums (p and ds rounded to bf16 before their products, as on the
    TPU), so |Δ| ≤ 2e-2·max|ref| + 2e-2·|ref|; the forward's output is
    the same bit for bit with and without the backward's statistics, and
    its f32 copy rounds to it. Squares of side 8 to 64 (64: the register
    reduction at H + W = 128), 28 (bsize 224: L % 64 != 0, the generic
    instantiation), a non-square 12 x 20, and past H + W = 128: 8 x 128,
    2 x 254 and 128 x 128 (bsize 1024)."""
    H, W = (G, G) if isinstance(G, int) else G
    seed = G if H == W else H + W
    g = torch.Generator(device="cpu").manual_seed(B * 100 + seed)
    hd, L = 64, H * W
    qkv = torch.randn(B, L, 3 * n * hd, generator=g).to(dev, torch.bfloat16)
    rel = torch.randn(B, L, n, H + W, generator=g).to(dev, torch.bfloat16)
    dout = torch.randn(B, L, n * hd, generator=g).to(dev, torch.bfloat16)
    scale = hd ** -0.5
    out, lse, out32 = _fwd_kernel(qkv, rel, scale, (H, W), n, True)
    assert torch.equal(out, _fwd_kernel(qkv, rel, scale, (H, W), n,
                                        False)[0])
    assert torch.equal(out32.bfloat16(), out)
    before = _build.LAUNCHES["attention_bwd"]
    got = attention_relpos_bwd(qkv, rel, out32, lse, dout, scale, (H, W), n)
    assert _build.LAUNCHES["attention_bwd"] == before + 1
    again = attention_relpos_bwd(qkv, rel, out32, lse, dout, scale, (H, W),
                                 n)
    ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (H, W), n)
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


@pytest.mark.parametrize("B,C,H,W", [(2, 2, 64, 96), (2, 2, 130, 70),
                                     (2, 1, 130, 70), (1, 2, 257, 1023),
                                     (1, 1, 257, 1023)])
def test_sampler_and_histogram_kernels(dev, B, C, H, W):
    """Kernels 2 and 3 against their plain versions, bitwise (the sampler
    built without contraction): W % 4 == 0 (float4 path) and not (scalar
    tail), C = 1 and 2; at integer positions the sampler is the exact
    gather of the label lookup."""
    # the original case (2, 2, 64, 96) keeps its seed
    rng = np.random.default_rng(0 if (B, C, H, W) == (2, 2, 64, 96)
                                else H + W + C)
    u = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(np.float32))
    gy = torch.arange(H, dtype=torch.float32)[:, None].expand(B, H, W)
    gx = torch.arange(W, dtype=torch.float32)[None, :].expand(B, H, W)
    py = torch.clamp(gy + torch.from_numpy(
        rng.uniform(-9, 9, (B, H, W)).astype(np.float32)), 0, H - 1)
    px = torch.clamp(gx + torch.from_numpy(
        rng.uniform(-9, 9, (B, H, W)).astype(np.float32)), 0, W - 1)
    args = [t.contiguous().to(dev) for t in (u, py, px)]
    assert torch.equal(bilinear_sample(*args), bilinear_sample_plain(*args))
    lab = torch.from_numpy(rng.integers(0, 5000, (B, C, H, W)).astype(
        np.float32)).to(dev)
    iy, ix = torch.round(args[1]), torch.round(args[2])
    got = bilinear_sample(lab, iy, ix)
    exact = torch.gather(lab.reshape(B, C, -1), 2, (iy * W + ix).long()
                         .reshape(B, 1, -1).expand(B, C, H * W))
    assert torch.equal(got.reshape(B, C, -1), exact)
    assert torch.equal(got, bilinear_sample_plain(lab, iy, ix))
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


def _design_field(B, H, W):
    """(B, H, W) ids and centres of the synthetic design (period-32 grid
    of radius-13 discs, one centre pixel each), the QC's input."""
    yy, xx = np.mgrid[:H, :W]
    cy, cx = yy // 32 * 32 + 16, xx // 32 * 32 + 16
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= 13 ** 2
    ids = np.where(inside, yy // 32 * -(-W // 32) + xx // 32 + 1, 0)
    cen = ((yy == cy) & (xx == cx)).astype(np.float32)
    return (np.repeat(ids[None].astype(np.int32), B, 0),
            np.repeat(cen[None], B, 0))


@pytest.mark.parametrize("name,shape,counts", [
    ("qc_8x1024", (8, 1024, 1024), [40, 80, 120, 40, 80, 120, 40, 80]),
    ("counts_0_1_13_1200", (4, 256, 256), [0, 1, 13, 1200]),
    ("counts_off_16", (4, 256, 384), [15, 17, 31, 50]),
    ("smallest_8x128", (3, 8, 128), [7, 16, 33]),
    ("target_512_1200", (1, 512, 512), [1200]),
])
def test_masked_diffusion_resident_kernel(dev, name, shape, counts):
    """Kernel 4 against its plain version, bitwise, at the geometries its
    route takes (H % 8 == 0, W % 128 == 0): the QC's 8 × 1024² with
    counts 40/80/120; counts 0, 1, 13 and 1200 and counts that are not
    multiples of the 16 iterations a launch runs; the smallest aligned
    tile (8 × 128, one window); one 512² training target at 1200. Random
    labels stand beside the design field in the small cases. The
    launches per call are the plan's (one pack, ceil(max count / depth)
    rounds in the window the shape gets)."""

    B, H, W = shape
    ids, cen = _design_field(B, H, W)
    if H * W <= 256 * 384:
        rng = np.random.default_rng(B + H + W)
        ids[1:] = rng.integers(0, 4, size=(B - 1, H, W))
        cen[1:] = rng.uniform(size=(B - 1, H, W)) < 0.05
    ids_t = torch.from_numpy(ids).to(dev)
    cen_t = torch.from_numpy(cen).to(dev)
    niter = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["masked_diffusion"]
    got = masked_diffusion(ids_t, cen_t, niter)
    assert _build.LAUNCHES["masked_diffusion"] - before == \
        diffusion_plan(B, H, W, max(counts)).launches
    assert torch.equal(got, masked_diffusion_plain(ids_t, cen_t, niter))


@pytest.mark.parametrize("shape,k", [((3, 48, 80), 1), ((2, 130, 70), 40),
                                     ((1, 200, 333), 8)])
def test_diffuse_blocked_kernel(dev, shape, k):
    """Kernel 7 against its plain version, bitwise: a nonzero T0, raw
    labels, counts that are not multiples of k or of the iterations per
    launch, a tile with no iteration, ragged windows."""
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


@pytest.mark.parametrize("name,shape,counts,k", [
    ("eval_1x448_80", (1, 448, 448), [80], 1),
    ("target_1x300x500", (1, 300, 500), [100], 1),
    ("ragged_2x130x70", (2, 130, 70), [13, 80], 1),
    ("strip_1x7x1000", (1, 7, 1000), [50], 1),
    ("counts_0_1_13_80_1200", (5, 96, 200), [0, 1, 13, 80, 1200], 1),
    ("T0_raw_k40", (3, 130, 300), [50, 0, 13], 40),
    ("qc_8x448", (8, 448, 448), [40, 80, 120, 40, 80, 120, 40, 80], 1),
])
def test_diffuse_blocked_kernel_at_path_shapes(dev, name, shape, counts, k):
    """Kernel 7 against its plain version, bitwise, at the evaluate QC of
    one 448² image (niter 80, the design field), an unaligned target,
    ragged shapes, a strip narrower than any window's interior, counts
    0/1/13/80/1200 (tiles that finish while others go on), a nonzero
    start on raw labels with k = 40, and eight 448² images; the launches
    per call are the plan's (one pack, ceil(max count / depth) rounds)."""
    B, H, W = shape
    rng = np.random.default_rng(H + W)
    if name in ("eval_1x448_80", "qc_8x448", "target_1x300x500"):
        ids, cen = _design_field(B, H, W)
        T0 = np.zeros(shape, np.float32)
    else:
        ids = (rng.integers(0, 5, size=shape) * 977).astype(np.int32)
        cen = (rng.uniform(size=shape) < 0.05).astype(np.float32)
        T0 = rng.uniform(0, 2, size=shape).astype(np.float32)
    ids, cen, T0 = (torch.from_numpy(a).to(dev) for a in (ids, cen, T0))
    niters = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = _build.LAUNCHES["diffuse_blocked"]
    got = diffuse_blocked(T0, ids, cen, niters, k=k)
    nmax = max(-(-c // k) * k for c in counts)
    assert _build.LAUNCHES["diffuse_blocked"] - before == \
        diffusion_plan(B, H, W, nmax).launches
    assert torch.equal(got, diffuse_blocked_plain(T0, ids, cen, niters, k=k))


def test_diffuse_dyn_int_count_reads_nothing_back(dev):
    """``_diffuse_dyn`` with an int count at the evaluate QC's shape makes
    the host wait for the device nowhere (CUDA's sync debug mode raises
    on a read-back), and gives the plain version's bits."""
    from classpose_tpu_torch.dynamics.flows import _diffuse_dyn

    ids, cen = (torch.from_numpy(a[0]).to(dev)
                for a in _design_field(1, 448, 448))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _diffuse_dyn(ids, cen, 80)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = torch.tensor([80], dtype=torch.int32, device=dev)
    assert torch.equal(got, diffuse_blocked_plain(
        torch.zeros_like(cen)[None], ids[None], cen[None], n, k=1)[0])


def _converged_landing(B, H, W):
    """Every foreground pixel of the design field lands on its cell's
    centre (clamped into the image) with cell 1; background pixels stay
    put with cell 0."""
    ids, _ = _design_field(B, H, W)
    yy, xx = np.mgrid[:H, :W]
    cy = np.minimum(yy // 32 * 32 + 16, H - 1)
    cx = np.minimum(xx // 32 * 32 + 16, W - 1)
    fg = ids > 0
    return (np.where(fg, cy, yy).astype(np.int32),
            np.where(fg, cx, xx).astype(np.int32), fg.astype(np.float32))


@pytest.mark.parametrize("case", ["one_bin_1024", "converged_8x1024",
                                  "converged_2x257x1023",
                                  "converged_offset_view"])
def test_histogram_kernel_contention(dev, case):
    """Kernel 3 against its plain version, bitwise, where pixels pile up:
    every pixel of a 1024² tile on one bin (2^20 adds), the converged
    design field at 8 × 1024², at W % 4 != 0 (images that start inside a
    warp's pixels), and on views 4 bytes past a 16-byte boundary; one
    launch a call."""
    if case == "one_bin_1024":
        fy = np.zeros((1, 1024, 1024), np.int32)
        fx, cell = fy.copy(), np.ones(fy.shape, np.float32)
    else:
        shape = (2, 257, 1023) if case == "converged_2x257x1023" else (
            8, 1024, 1024)
        fy, fx, cell = _converged_landing(*shape)
    args = [torch.from_numpy(a).to(dev) for a in (fy, fx, cell)]
    if case == "converged_offset_view":
        args = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
                .view(fy.shape) for t in args]
        assert all(t.data_ptr() % 16 == 4 for t in args)
    before = _build.LAUNCHES["landing_histogram"]
    got = landing_histogram(*args)
    assert _build.LAUNCHES["landing_histogram"] - before == 1
    ref = landing_histogram_plain(*args)
    assert torch.equal(got, ref)
    if case == "one_bin_1024":
        assert float(got[0, 0, 0]) == 2.0 ** 20 and float(got.sum()) == \
            2.0 ** 20
    else:
        assert float(got.sum()) == float(args[2].sum())


@pytest.mark.parametrize("dtype,G", [(torch.float32, 8), (torch.float32, 16),
                                     (torch.bfloat16, 8),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 28), (torch.float32, 64),
                                     (torch.float32, (12, 20)),
                                     (torch.bfloat16, 28),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, (12, 20)),
                                     (torch.float32, (8, 128)),
                                     (torch.float32, (2, 254)),
                                     (torch.float32, 128),
                                     (torch.bfloat16, (8, 128)),
                                     (torch.bfloat16, (2, 254)),
                                     (torch.bfloat16, 128)])
def test_flash_attention_relpos_kernel(dev, dtype, G):
    """Kernel 8 against its plain version: fp32 products on the CUDA
    cores, sums in another order, |Δ| ≤ 1e-4 + 1e-4·|ref|; bf16 as kernel
    1, 2e-2; its route raises where a gradient would flow. Grids down to
    one key block, L % 128 != 0 (28 x 28, 12 x 20), H + W = 128, and past
    it (8 x 128, 2 x 254, 128 x 128: the fp32 body stages each key
    block's bias entries)."""
    H, W = (G, G) if isinstance(G, int) else G
    g = torch.Generator(device="cpu").manual_seed(G if H == W else H * W)
    B, n, hd, L = 2, 3, 64, H * W
    q, k, v = (torch.randn(B, n, L, hd, generator=g).to(dev, dtype)
               for _ in range(3))
    if L > 4096:  # the plain version's (B, n, L, L) intermediates
        B, n = 1, 2
        q, k, v = (t[:B, :n].contiguous() for t in (q, k, v))
    rh = (2 * torch.randn(B, n, L, H, generator=g)).to(dev, dtype)
    rw = (2 * torch.randn(B, n, L, W, generator=g)).to(dev, dtype)
    before = _build.LAUNCHES["flash_attention_relpos"]
    got = flash_attention_relpos(q, k, v, rh, rw, hd ** -0.5, (H, W))
    assert _build.LAUNCHES["flash_attention_relpos"] == before + 1
    ref = flash_attention_relpos_plain(q, k, v, rh, rw, hd ** -0.5)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_relpos(q.requires_grad_(), k, v, rh, rw, 0.125,
                               (H, W))


def test_attention_kernels_refuse_past_the_limit(dev):
    """A grid with H + W = 257 (one past MAX_REL) raises ``ValueError`` on
    every attention kernel route, before any launch."""
    H, W, n = 1, 256, 1
    L = H * W
    qkv = torch.zeros(1, L, 3 * n * 64, device=dev, dtype=torch.bfloat16)
    rel = torch.zeros(1, L, n, H + W, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H\\+W <= 256"):
        attention_relpos(qkv, rel, 0.125, (H, W), n)
    lse = torch.zeros(1, n, L, device=dev)
    out32 = torch.zeros(1, L, n * 64, device=dev)
    dout = torch.zeros(1, L, n * 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H\\+W <= 256"):
        attention_relpos_bwd(qkv, rel, out32, lse, dout, 0.125, (H, W), n)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, n, L, 64, device=dev, dtype=dtype)
        with pytest.raises(ValueError, match="H\\+W <= 256"):
            flash_attention_relpos(q, q, q,
                                   torch.zeros(1, n, L, H, device=dev,
                                               dtype=dtype),
                                   torch.zeros(1, n, L, W, device=dev,
                                               dtype=dtype), 0.125, (H, W))


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


def test_fast_qc_diffusion_kernel(dev):
    """Kernel 4 at the ``--fast_qc`` QC's shape, bitwise: 8 tiles of
    1024² labels at every other pixel (8 × 512²), one int count for the
    batch as ``eval_batch`` passes it (nothing read back), with the plan's
    launches."""
    import classpose_tpu_torch.dynamics.flows as port_flows
    from classpose_tpu_torch.ops.diffusion import diffuse_counts_plain

    ids, cen = _design_field(8, 512, 512)
    ids_t = torch.from_numpy(ids).to(dev)
    cen_t = torch.from_numpy(cen).to(dev)
    before = _build.LAUNCHES["masked_diffusion"]
    got = port_flows._diffuse_dyn(ids_t, cen_t, 80)
    assert _build.LAUNCHES["masked_diffusion"] - before == \
        diffusion_plan(8, 512, 512, 80).launches
    n = torch.full((8,), 80, dtype=torch.int32, device=dev)
    assert torch.equal(got, diffuse_counts_plain(ids_t, cen_t, n, 80))


def test_vit_l_pt_loads_to_card(dev, tmp_path):
    """A ViT-L checkpoint in the published layout (every key and shape of
    the manifest, 6 classes, seeded values) builds its model on the card:
    the config read off its shapes is the default ViT-L's, every tensor
    arrives unchanged, and a bf16 forward of one crop is finite."""
    from classpose_tpu_torch.nn.convert import published_names
    from classpose_tpu_torch.nn.manifest import vit_l_manifest
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
    from classpose_tpu_torch.runner import ClassposeModel

    man = vit_l_manifest(6)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(s, generator=g) * 0.02 for k, s in man.items()}
    for name, c in (("W2", 3), ("W3", 6)):
        sd[name] = torch.eye(c * 64).reshape(c * 64, c, 8, 8)
    torch.save(sd, tmp_path / "conic.pt")
    model = ClassposeModel(pretrained_model=str(tmp_path / "conic.pt"),
                           precision="bf16", device=dev)
    assert model.cfg == ClassTransformerConfig(n_cell_classes=6,
                                               dtype="bfloat16")
    own = model.net.state_dict()
    for pub, port in published_names(sd).items():
        assert own[port].device.type == "cuda"
        assert torch.equal(own[port].cpu(), sd[pub]), pub
    x = torch.rand((1, 3, 256, 256), generator=g).to(dev)
    with torch.no_grad():
        y = model.net(x)[0]
    assert y.shape == (1, 9, 256, 256) and torch.isfinite(y).all()
