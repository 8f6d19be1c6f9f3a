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
