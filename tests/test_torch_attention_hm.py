"""Kernel 8's plain version (``flash_attention_relpos`` on the CPU)
against the JAX head-major Pallas kernel in interpret mode on the three
bias fixtures of ``tests/test_attention_kernel.py``, at fp32 and that
test's tolerance (2e-3); and the port's fp32 ``Attention`` without a
gradient (head-major q, k, v, two einsums, kernel 8's route) against the
flax fp32 branch to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn.attention import flash_attention_relpos as jax_flash
from classpose_tpu.nn.vit_sam import Attention as JaxAttention
from classpose_tpu_torch.nn import attention as port_attention
from classpose_tpu_torch.nn.attention import (
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from classpose_tpu_torch.nn.vit_sam import Attention

B, n, H, W, hd = 1, 2, 8, 8, 64
L = H * W


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, n, L, hd)).astype(np.float32)
            for _ in range(3)]


def _bias(name):
    if name == "row_dep_h":
        return (np.broadcast_to(np.arange(H, dtype=np.float32) * 3.0,
                                (B, n, L, H)).copy(),
                np.zeros((B, n, L, W), np.float32))
    if name == "col_dep_w":
        return (np.zeros((B, n, L, H), np.float32),
                np.broadcast_to(np.arange(W, dtype=np.float32) * 3.0,
                                (B, n, L, W)).copy())
    return ((np.random.default_rng(1).normal(size=(B, n, L, H)) * 2).astype(
                np.float32),
            (np.random.default_rng(2).normal(size=(B, n, L, W)) * 2).astype(
                np.float32))


@pytest.mark.parametrize("name", ["row_dep_h", "col_dep_w", "random_both"])
def test_plain_matches_pallas_interpret(name):
    q, k, v = _qkv()
    rh, rw = _bias(name)
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v, rh, rw)), hd ** -0.5,
                    grid_hw=(H, W), interpret=True)
    got = flash_attention_relpos(*(torch.from_numpy(a)
                                   for a in (q, k, v, rh, rw)),
                                 hd ** -0.5, (H, W))
    assert got.dtype == torch.float32 and got.shape == (B, n, L, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=2e-3, rtol=2e-3)


def test_bf16_plain_keeps_the_dtype():
    q, k, v = _qkv(3)
    rh, rw = _bias("random_both")
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v, rh, rw)]
    got = flash_attention_relpos(*args, hd ** -0.5, (H, W))
    assert got.dtype == torch.bfloat16
    ref = flash_attention_relpos_plain(*(a.float() for a in args),
                                       hd ** -0.5)
    # probabilities rounded to bf16 before the product, output to bf16
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)


def test_bad_shapes_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    rh, rw = (torch.from_numpy(a) for a in _bias("random_both"))
    with pytest.raises(ValueError):
        flash_attention_relpos(q, k, v, rw[..., :4], rw, 0.125, (H, W))
    with pytest.raises(ValueError):
        flash_attention_relpos(q, k, v, rh, rw, 0.125, (H, W + 1))
    with pytest.raises(ValueError):
        flash_attention_relpos(q, k.double(), v, rh, rw, 0.125, (H, W))


@pytest.mark.parametrize("dim,heads,grid", [(128, 2, 8), (64, 4, 6)])
def test_fp32_attention_matches_flax_fp32_branch(dim, heads, grid,
                                                 monkeypatch):
    """Same weights (random, rel-pos tables included) and input: the
    port's Attention under ``no_grad`` takes the head-major route through
    ``flash_attention_relpos``; the flax module at fp32 takes its XLA
    head-major branch."""
    rng = np.random.default_rng(grid)
    x = rng.normal(size=(2, grid, grid, dim)).astype(np.float32)
    mod = JaxAttention(num_heads=heads, input_size=(grid, grid))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.2, jnp.float32),
        params)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))

    p = params["params"]
    att = Attention(dim, heads, (grid, grid))
    with torch.no_grad():
        att.qkv.weight.copy_(torch.from_numpy(np.array(p["qkv"]["kernel"]).T))
        att.qkv.bias.copy_(torch.from_numpy(np.array(p["qkv"]["bias"])))
        att.proj.weight.copy_(
            torch.from_numpy(np.array(p["proj"]["kernel"]).T))
        att.proj.bias.copy_(torch.from_numpy(np.array(p["proj"]["bias"])))
        att.rel_pos_h.copy_(torch.from_numpy(np.array(p["rel_pos_h"])))
        att.rel_pos_w.copy_(torch.from_numpy(np.array(p["rel_pos_w"])))
    calls = []
    monkeypatch.setattr(
        "classpose_tpu_torch.nn.vit_sam.flash_attention_relpos",
        lambda *a: calls.append(1) or port_attention.flash_attention_relpos(
            *a))
    with torch.no_grad():
        got = att(torch.from_numpy(x)).numpy()
    assert calls == [1]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # with a gradient the plain route under autograd gives the same
    with_grad = att(torch.from_numpy(x))
    assert calls == [1] and with_grad.grad_fn is not None
    np.testing.assert_allclose(with_grad.detach().numpy(), got, atol=1e-5,
                               rtol=1e-5)
