"""Port attention backward (plain version of the CUDA kernel and the
differentiable route around the kernels) against the JAX package's
``_attn_core`` backward: its Pallas kernel in interpret mode and its XLA
route, at the shapes and tolerance of tests/test_attention_bwd.py; then
the gradients of one fp32 transformer block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn.attention import _attn_core
from classpose_tpu.nn.vit_sam import Block as JaxBlock
from classpose_tpu_torch.nn.attention import (
    AttentionRelPos,
    attention_relpos,
    attention_relpos_bwd,
    attention_relpos_bwd_plain,
)
from classpose_tpu_torch.nn.convert import load_into, params_from_jax
from classpose_tpu_torch.nn.vit_sam import Block

B, n, hd, H, W = 2, 2, 64, 8, 8
L = H * W
SCALE = float(hd) ** -0.5


def _operands(seed):
    rng = np.random.default_rng(seed)
    qkv = (rng.normal(size=(B, L, 3 * n * hd)) * 0.3).astype(np.float32)
    rel = (rng.normal(size=(B, L, n, H + W)) * 0.3).astype(np.float32)
    wout = rng.normal(size=(B, L, n * hd)).astype(np.float32)
    return qkv, rel, wout


def _jax_grads(qkv, rel, wout):
    def loss(a, r):
        out = _attn_core(a, r, SCALE, (H, W), n, 2, True)
        return jnp.sum(out.reshape(wout.shape) * wout)

    gq, gr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv),
                                            jnp.asarray(rel))
    return np.asarray(gq), np.asarray(gr)


def _port_grads(qkv, rel, wout, route):
    a, r, w = (torch.from_numpy(t) for t in (qkv, rel, wout))
    if route == "plain":
        dq, dr = attention_relpos_bwd_plain(a, r, w, SCALE, (H, W), n)
        return dq.numpy(), dr.numpy()
    a.requires_grad_()
    r.requires_grad_()
    out = attention_relpos(a, r, SCALE, (H, W), n)
    assert out.grad_fn is not None
    (out * w).sum().backward()
    return a.grad.numpy(), r.grad.numpy()


@pytest.mark.parametrize("route", ["plain", "autograd"])
@pytest.mark.parametrize("mode,seed", [("pallas", 0), ("xla", 1)])
def test_bwd_matches_jax(monkeypatch, mode, seed, route):
    """``CLASSPOSE_ATTN_BWD=pallas`` runs ``_attn_bwd_pallas`` in interpret
    mode, ``xla`` the vjp of the reference; the port's plain backward and
    its autograd route (the kernels' plumbing with the plain versions)
    match both to the JAX test's own tolerance."""
    monkeypatch.setenv("CLASSPOSE_ATTN_BWD", mode)
    qkv, rel, wout = _operands(seed)
    gq_ref, gr_ref = _jax_grads(qkv, rel, wout)
    gq, gr = _port_grads(qkv, rel, wout, route)
    np.testing.assert_allclose(gq, gq_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gr, gr_ref, rtol=2e-4, atol=2e-5)


def test_autograd_route_saves_no_lse_on_cpu():
    """On a CPU tensor the Function takes the plain forward (no f32 output
    or log-sum-exp to save) and its backward goes to the plain vjp."""
    qkv, rel, _ = _operands(2)
    a = torch.from_numpy(qkv).requires_grad_()
    r = torch.from_numpy(rel)
    out = AttentionRelPos.apply(a, r, SCALE, (H, W), n, True)
    assert out.grad_fn.saved_tensors[2:] == (None, None)
    out.sum().backward()
    assert a.grad is not None and r.grad is None


def test_bwd_checks_raise():
    qkv, rel, wout = (torch.from_numpy(t) for t in _operands(3))
    with pytest.raises(ValueError):
        attention_relpos_bwd_plain(qkv, rel, wout[..., :-1], SCALE, (H, W), n)
    with pytest.raises(ValueError):
        attention_relpos_bwd_plain(qkv, rel, wout, SCALE, (H, W + 1), n)
    lse = torch.zeros(B, n, L)
    # the kernel wrapper takes CUDA tensors only, and raises on a CPU one
    with pytest.raises(ValueError, match="CUDA"):
        attention_relpos_bwd(qkv.bfloat16(), rel.bfloat16(), wout, lse,
                             wout.bfloat16(), SCALE, (H, W), n)


def test_block_gradients_match_jax():
    """One fp32 block: the gradients of ``sum(block(x)·w)`` with respect
    to every parameter match the flax block's (fp32 sums in another
    order: rtol 1e-4, atol 1e-6), and those of the attention's inputs —
    qkv, norm1 and the rel-pos tables — are non-zero, so the attention
    branch carries its gradient."""
    C = n * hd
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(size=(B, H, W, C)).astype(np.float32)
    blk = JaxBlock(n, 4.0, (H, W), dtype=jnp.float32)
    params = blk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05, jnp.float32),
        params)

    def loss(p):
        return jnp.sum(blk.apply(p, jnp.asarray(x)) * w)

    ref = params_from_jax(jax.grad(loss)(params))

    port = Block(C, n, 4.0, (H, W))
    load_into(port, params_from_jax(params))
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("attn.qkv.weight", "norm1.weight", "attn.rel_pos_h",
              "attn.rel_pos_w"):
        assert float(got[k].abs().max()) > 0, k


@pytest.mark.parametrize("GH,GW", [(8, 128), (2, 254)])
def test_plain_bwd_matches_jax_past_128(GH, GW):
    """Grids past H + W = 128 (8 x 128; 2 x 254 at the limit H + W = 256),
    which kernel 5 takes since the rest of fault 3: the plain backward
    against the vjp of the JAX package's XLA reference (``_attn_core_ref``,
    its backward route off the TPU) to the tolerance of the test above."""
    from classpose_tpu.nn.attention import _attn_core_ref

    rng = np.random.default_rng(GH + GW)
    Lg, nb = GH * GW, 2
    qkv = (rng.normal(size=(1, Lg, 3 * nb * hd)) * 0.3).astype(np.float32)
    rel = (rng.normal(size=(1, Lg, nb, GH + GW)) * 0.3).astype(np.float32)
    wout = rng.normal(size=(1, Lg, nb * hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, r: _attn_core_ref(a, r, SCALE, (GH, GW), nb),
                     jnp.asarray(qkv), jnp.asarray(rel))
    gq_ref, gr_ref = (np.asarray(g) for g in vjp(jnp.asarray(wout)))
    gq, gr = attention_relpos_bwd_plain(
        *(torch.from_numpy(t) for t in (qkv, rel, wout)), SCALE, (GH, GW),
        nb)
    np.testing.assert_allclose(gq.numpy(), gq_ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gr.numpy(), gr_ref, rtol=2e-4, atol=2e-5)


def _hopper_bwd_emulation(qkv, rel, dout, scale, grid_hw, nh,
                          drel_from="hilo"):
    """What ``csrc/attention_bwd.cu`` computes, in fp32 torch with its
    roundings: p = exp2(s·scale·log2e + bias·log2e − lse·log2e) from the
    forward's lse; ds = p·(dp − delta) in fp32, delta from the fp32
    output; p rounded to bf16 for dv, ds for dq and dk; the bias
    gradients summed per 64-key block, fp32, then added block by block,
    from ``drel_from``: ds split into bf16 hi + lo against 0/1 columns
    (``"hilo"``, any grid), the fp32 ds itself (``"fp32"``, the square
    grids of side 16 and 32), or the bf16 ds alone (``"hi"``, a
    rounding the kernel does not use). Returns (dqkv, drel) in fp32."""
    B, L, C3 = qkv.shape
    H, W = grid_hw
    bf = lambda x: x.bfloat16().float()  # noqa: E731
    q, k, v = (qkv[..., i * nh * hd:(i + 1) * nh * hd].reshape(
        B, L, nh, hd).transpose(1, 2) for i in range(3))
    do = dout.reshape(B, L, nh, hd).transpose(1, 2)
    bias = (rel[..., :H].transpose(1, 2)[..., :, None]
            + rel[..., H:].transpose(1, 2)[..., None, :]).reshape(B, nh, L, L)
    s = q @ k.transpose(-1, -2)
    t = s * scale + bias
    lse = torch.logsumexp(t, -1, keepdim=True)
    o = torch.softmax(t, -1) @ v
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp2(s * (scale * LOG2E) + bias * LOG2E - lse * LOG2E)
    ds = p * (do @ v.transpose(-1, -2) - delta)
    dv = bf(p).transpose(-1, -2) @ do
    dq = bf(ds) @ k * scale
    dk = bf(ds).transpose(-1, -2) @ q * scale
    hi = bf(ds)
    parts = {"hilo": (hi, bf(ds - hi)), "fp32": (ds,),
             "hi": (hi,)}[drel_from]
    j = torch.arange(L)
    drel = torch.zeros(B, nh, L, H + W)
    for k0 in range(0, L, 64):
        blk = torch.zeros(B, nh, L, H + W)
        for part in parts:
            x = part[..., k0:k0 + 64]
            blk.index_add_(3, j[k0:k0 + 64] // W, x)
            blk.index_add_(3, H + j[k0:k0 + 64] % W, x)
        drel = drel + blk
    dqkv = torch.cat([g.transpose(1, 2).reshape(B, L, nh * hd)
                      for g in (dq, dk, dv)], -1)
    return dqkv, drel.transpose(1, 2)


LOG2E = 1.4426950408889634


@pytest.mark.parametrize("GH,GW", [(8, 8), (32, 32), (28, 28), (12, 20),
                                   (8, 128)])
def test_hopper_bwd_arithmetic_matches_plain(GH, GW):
    """Kernel 5's arithmetic (``_hopper_bwd_emulation``) against the plain
    backward on bf16-representable operands: the bias gradients from the
    hi + lo split of ds to 2e-5·max|ref| + 1e-4·|ref| (fp32 sums in
    another order), a bound the bf16 ds alone misses (the check that the
    split carries the precision the contract asks for; the square grid of
    side 32 sums the fp32 ds itself); dq, dk, dv to 2e-2·max|ref| +
    2e-2·|ref|, the card tests' tolerance for the bf16 rounding of p and
    ds."""
    rng = np.random.default_rng(GH * GW)
    Lg, nb = GH * GW, 2
    qkv, rel, dout = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        .bfloat16().float()
        for shape in ((1, Lg, 3 * nb * hd), (1, Lg, nb, GH + GW),
                      (1, Lg, nb * hd)))
    rel = rel * 2
    dq_ref, dr_ref = attention_relpos_bwd_plain(qkv, rel, dout, SCALE,
                                                (GH, GW), nb)
    mode = "fp32" if GH == GW and GW in (16, 32) else "hilo"
    got_q, got_r = _hopper_bwd_emulation(qkv, rel, dout, SCALE, (GH, GW),
                                         nb, mode)
    err_q = (got_q - dq_ref).abs()
    assert bool((err_q <= 2e-2 * dq_ref.abs().max()
                 + 2e-2 * dq_ref.abs()).all()), float(err_q.max())

    def within(drel):
        err = (drel - dr_ref).abs()
        return bool((err <= 2e-5 * dr_ref.abs().max()
                     + 1e-4 * dr_ref.abs()).all())

    assert within(got_r)
    assert not within(_hopper_bwd_emulation(qkv, rel, dout, SCALE, (GH, GW),
                                            nb, "hi")[1])
