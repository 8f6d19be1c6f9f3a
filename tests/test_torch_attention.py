"""Port attention (plain version of the CUDA kernel) against the JAX
Pallas kernel in interpret mode and against the JAX reference, at the
shapes and tolerance of tests/test_attention_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn.attention import (
    attention_reference,
    flash_attention_relpos_blc,
)
from classpose_tpu_torch.nn.attention import (
    attention_relpos,
    attention_relpos_plain,
)

B, n, H, W, hd = 1, 2, 8, 8, 64
L = H * W


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, L, 3 * n * hd)).astype(np.float32)
    rel = (rng.normal(size=(B, L, n, H + W)) * 2).astype(np.float32)
    return qkv, rel


def _port(qkv, rel):
    return attention_relpos(torch.from_numpy(qkv), torch.from_numpy(rel),
                            hd ** -0.5, (H, W), n).numpy()


@pytest.mark.parametrize("seed,variant", [(0, 2), (3, 2), (17, 0)])
def test_plain_matches_pallas_interpret(seed, variant):
    qkv, rel = _inputs(seed)
    ref = flash_attention_relpos_blc(
        jnp.asarray(qkv), jnp.asarray(rel), None, hd ** -0.5,
        grid_hw=(H, W), interpret=True, num_heads=n, fused_bias=variant,
    )
    np.testing.assert_allclose(
        _port(qkv, rel), np.asarray(ref, np.float32).reshape(B, L, n * hd),
        atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name", ["row_dep_h", "col_dep_w", "random"])
def test_plain_matches_reference(name):
    """Strongly row- or column-dependent biases catch a swapped j//W,
    j%W construction."""
    qkv, rel = _inputs(1)
    if name == "row_dep_h":
        rel[..., :H] = np.arange(H, dtype=np.float32) * 3.0
        rel[..., H:] = 0.0
    elif name == "col_dep_w":
        rel[..., :H] = 0.0
        rel[..., H:] = np.arange(W, dtype=np.float32) * 3.0
    q, k, v = (
        jnp.swapaxes(jnp.asarray(qkv[..., i * n * hd:(i + 1) * n * hd])
                     .reshape(B, L, n, hd), 1, 2)
        for i in range(3)
    )
    ref = attention_reference(
        q, k, v, jnp.swapaxes(jnp.asarray(rel[..., :H]), 1, 2),
        jnp.swapaxes(jnp.asarray(rel[..., H:]), 1, 2), hd ** -0.5)
    ref = np.asarray(jnp.swapaxes(ref, 1, 2)).reshape(B, L, n * hd)
    np.testing.assert_allclose(_port(qkv, rel), ref, atol=2e-3, rtol=2e-3)


def test_wrapper_rejects_bad_shapes():
    qkv, rel = _inputs(0)
    with pytest.raises(ValueError):
        attention_relpos(torch.from_numpy(qkv), torch.from_numpy(rel),
                         hd ** -0.5, (H, W + 1), n)


# ------------------------------------------- the Hopper forward's arithmetic

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _hopper_fwd_emulation(qkv, rel, scale, grid_hw, n, bq=128, bk=128):
    """What ``csrc/attn_fwd.cuh`` computes, in its order, in fp32 torch:
    blocks of ``bq`` queries sweep blocks of ``bk`` keys (keys past L read
    as zeros, as TMA fills them, and masked to -inf); logits in the exp2
    domain t = s·scale·log2e + (rel[i, j//W] + rel[i, H + j%W])·log2e with
    the bias gathered per logit; an online softmax with a running max and
    sum; p rounded to bf16 before the p·v product; the output divided by
    the sum at the end. Returns (out (B, L, n·hd) fp32, natural-log
    lse (B, n, L) = (m + log2 l)·ln 2)."""
    B, L, C3 = qkv.shape
    H, W = grid_hw
    hd = C3 // (3 * n)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].float()
               .reshape(B, L, n, hd).transpose(1, 2) for i in range(3))
    rh = rel[..., :H].float().transpose(1, 2) * LOG2E   # (B, n, L, H)
    rw = rel[..., H:].float().transpose(1, 2) * LOG2E   # (B, n, L, W)
    out = torch.zeros(B, n, L, hd)
    lse = torch.zeros(B, n, L)
    for q0 in range(0, L, bq):
        rows = torch.arange(q0, min(q0 + bq, L))
        m = torch.full((B, n, len(rows)), -torch.inf)
        lsum = torch.zeros(B, n, len(rows))
        o = torch.zeros(B, n, len(rows), hd)
        for k0 in range(0, L, bk):
            j = torch.arange(k0, k0 + bk)
            valid = j < L
            jc = j.clamp(max=L - 1)
            kb = k[:, :, jc] * valid[:, None]
            vb = v[:, :, jc] * valid[:, None]
            s = q[:, :, rows] @ kb.transpose(-1, -2)
            bias = (rh[:, :, rows][..., jc // W]
                    + rw[:, :, rows][..., jc % W])
            t = torch.where(valid, s * (scale * LOG2E) + bias, -torch.inf)
            mx = torch.maximum(m, t.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(t - mx[..., None])
            lsum = lsum * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vb
            m = mx
        out[:, :, rows] = o / lsum[..., None]
        lse[:, :, rows] = (m + torch.log2(lsum)) * LN2
    return out.transpose(1, 2).reshape(B, L, n * hd), lse


def _bf16_inputs(seed, B, n, H, W):
    """qkv and rel as bf16-representable fp32, the kernel's operands."""
    rng = np.random.default_rng(seed)
    L = H * W
    qkv = rng.normal(size=(B, L, 3 * n * hd)).astype(np.float32)
    rel = (rng.normal(size=(B, L, n, H + W)) * 2).astype(np.float32)
    return (torch.from_numpy(qkv).bfloat16().float().numpy(),
            torch.from_numpy(rel).bfloat16().float().numpy())


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("variant", [0, 1, 2])
def test_hopper_arithmetic_matches_pallas_interpret(G, variant):
    """The emulated Hopper forward against the JAX package's Pallas
    kernel (``_attn_pallas``, interpret mode) in each bias variant, at
    L = 64 (one key block, masked past L), 256 and 1024: |Δ| ≤ 4e-3 +
    4e-3·|ref|, the room the bf16 rounding of p leaves (the Pallas kernel
    at fp32 inputs does not round it); a swapped j//W, j%W or a lost key
    block is off by O(1)."""
    from classpose_tpu.nn.attention import _attn_pallas

    qkv, rel = _bf16_inputs(G, 1, 2, G, G)
    ref = np.asarray(_attn_pallas(jnp.asarray(qkv), jnp.asarray(rel),
                                  hd ** -0.5, (G, G), 2, variant, True),
                     np.float32)
    got, _ = _hopper_fwd_emulation(torch.from_numpy(qkv),
                                   torch.from_numpy(rel), hd ** -0.5, (G, G),
                                   2)
    np.testing.assert_allclose(got.numpy(), ref, atol=4e-3, rtol=4e-3)


@pytest.mark.parametrize("H,W", [(8, 8), (16, 16), (32, 32), (8, 24),
                                 (24, 8), (12, 20), (28, 28), (8, 128),
                                 (2, 254)])
def test_hopper_arithmetic_matches_plain(H, W):
    """The emulated Hopper forward against ``attention_relpos_plain`` (out:
    4e-3 + 4e-3·|ref|, as above) and its natural-log lse against the
    plain fp32 logits' ``torch.logsumexp`` (1e-4 + 1e-5·|lse|: fp32 sums
    in another order), on square and non-square grids, with L % 128 != 0
    (12 x 20, 28 x 28: keys past L masked in the last block)."""
    B, n = 2, 3
    qkv, rel = (torch.from_numpy(a) for a in _bf16_inputs(H + W, B, n, H,
                                                          W))
    L = H * W
    scale = hd ** -0.5
    got, lse = _hopper_fwd_emulation(qkv, rel, scale, (H, W), n)
    ref = attention_relpos_plain(qkv, rel, scale, (H, W), n)
    torch.testing.assert_close(got, ref, atol=4e-3, rtol=4e-3)
    q, k = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
            .transpose(1, 2) for i in range(2))
    s = q @ k.transpose(-1, -2) * scale + (
        rel[..., :H].transpose(1, 2)[..., :, None]
        + rel[..., H:].transpose(1, 2)[..., None, :]).reshape(B, n, L, L)
    lse_ref = torch.logsumexp(s, -1)
    assert bool(((lse - lse_ref).abs() <= 1e-4 + 1e-5 * lse_ref.abs()).all())


@pytest.mark.parametrize("H,W", [(8, 128), (2, 254)])
def test_plain_matches_reference_past_128(H, W):
    """Grids past H + W = 128, which the kernels take since the rest of
    fault 3 (8 x 128; 2 x 254 at the limit H + W = 256): the plain
    token-major forward against the JAX package's ``attention_reference``
    on the same operands, at fp32 to 1e-5."""
    rng = np.random.default_rng(H + W)
    L = H * W
    qkv = rng.normal(size=(1, L, 3 * n * hd)).astype(np.float32)
    rel = (rng.normal(size=(1, L, n, H + W)) * 2).astype(np.float32)
    q, k, v = (
        jnp.swapaxes(jnp.asarray(qkv[..., i * n * hd:(i + 1) * n * hd])
                     .reshape(1, L, n, hd), 1, 2)
        for i in range(3))
    rh = jnp.swapaxes(jnp.asarray(rel[..., :H]), 1, 2)
    rw = jnp.swapaxes(jnp.asarray(rel[..., H:]), 1, 2)
    ref = np.asarray(attention_reference(q, k, v, rh, rw, hd ** -0.5),
                     np.float32).transpose(0, 2, 1, 3).reshape(1, L, n * hd)
    got = attention_relpos(torch.from_numpy(qkv), torch.from_numpy(rel),
                           hd ** -0.5, (H, W), n).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_kernel_routes_reject_unaligned_operands():
    """The Hopper forward reads q, k, v by TMA and the bias rows by
    16-byte copies: both kernel routes refuse an operand whose address is
    not 16-byte aligned before anything is launched."""
    from classpose_tpu_torch.nn.attention import _check_kernel, _hm_kernel

    G, n = 8, 2
    L = G * G
    qkv = torch.zeros(B, L, 3 * n * hd, dtype=torch.bfloat16)
    rel = torch.zeros(B, L, n, 2 * G, dtype=torch.bfloat16)
    _check_kernel(qkv, rel, hd, L, G, G)
    shifted = torch.zeros(rel.numel() + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match="aligned"):
        _check_kernel(qkv, shifted.view(rel.shape), hd, L, G, G)
    q = torch.zeros(B, n, L, hd, dtype=torch.bfloat16)
    rh = torch.zeros(B, n, L, G, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        _hm_kernel(q, q, q, rh, torch.zeros(rh.numel() + 1,
                                            dtype=torch.bfloat16)[1:]
                   .view(rh.shape), hd ** -0.5, (G, G))
