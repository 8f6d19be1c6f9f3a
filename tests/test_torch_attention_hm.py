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


@pytest.mark.parametrize("dim,heads,grid,dtype", [
    pytest.param(128, 2, 8, "float32", id="128-2-8"),
    pytest.param(64, 4, 6, "float32", id="64-4-6"),
    # crop grids the kernels take since fault 3: bsize 224 at patch 8
    # (L = 784, L % 64 != 0) and a non-square one
    pytest.param(64, 2, (28, 28), "float32", id="64-2-28x28"),
    pytest.param(64, 2, (12, 20), "float32", id="64-2-12x20"),
    pytest.param(64, 2, (28, 28), "bfloat16", id="64-2-28x28-bf16"),
    pytest.param(64, 2, (12, 20), "bfloat16", id="64-2-12x20-bf16"),
])
def test_fp32_attention_matches_flax_fp32_branch(dim, heads, grid, dtype,
                                                 monkeypatch):
    """Same weights (random, rel-pos tables included) and input: the
    port's Attention under ``no_grad`` takes the head-major route through
    ``flash_attention_relpos`` at fp32 and the token-major route through
    ``attention_relpos`` at bf16; the flax module takes its fp32 XLA
    branch. fp32 to 1e-5; bf16 (weights and input on the bf16 grid, the
    port rounding qkv, the bias, p and the outputs to bf16) to
    2e-2·max|ref| + 2e-2·|ref|. The flax bf16 branch is no reference
    here: it rounds the L x L logits to bf16 as well, and was 0.19 off
    the port's bf16 output at 28 x 28."""
    H, W = (grid, grid) if isinstance(grid, int) else grid
    rng = np.random.default_rng(grid if isinstance(grid, int) else H * W)
    x = rng.normal(size=(2, H, W, dim)).astype(np.float32)
    tdt = getattr(torch, dtype)
    mod = JaxAttention(num_heads=heads, input_size=(H, W))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.2, jnp.float32),
        params)
    if dtype == "bfloat16":
        # weights and input on the bf16 grid, so both sides start from the
        # same values and the flax fp32 branch is the exact reference
        params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)), np.float32)

    p = params["params"]
    att = Attention(dim, heads, (H, W))
    with torch.no_grad():
        att.qkv.weight.copy_(torch.from_numpy(np.array(p["qkv"]["kernel"]).T))
        att.qkv.bias.copy_(torch.from_numpy(np.array(p["qkv"]["bias"])))
        att.proj.weight.copy_(
            torch.from_numpy(np.array(p["proj"]["kernel"]).T))
        att.proj.bias.copy_(torch.from_numpy(np.array(p["proj"]["bias"])))
        att.rel_pos_h.copy_(torch.from_numpy(np.array(p["rel_pos_h"])))
        att.rel_pos_w.copy_(torch.from_numpy(np.array(p["rel_pos_w"])))
    att = att.to(tdt)
    route = ("flash_attention_relpos" if dtype == "float32"
             else "attention_relpos")
    calls = []
    monkeypatch.setattr(
        f"classpose_tpu_torch.nn.vit_sam.{route}",
        lambda *a: calls.append(1) or getattr(port_attention, route)(*a))
    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        got = att(xt).float().numpy()
    assert calls == [1]
    if dtype != "float32":
        # bf16 outputs of a bf16 projection: the error scales with the
        # output's magnitude (the form of the kernels' bf16 card tests)
        err = np.abs(got - ref)
        assert (err <= 2e-2 * np.abs(ref).max() + 2e-2 * np.abs(ref)).all(), \
            (err.max(), np.abs(ref).max())
        return
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    # with a gradient the plain route under autograd gives the same
    with_grad = att(xt)
    assert calls == [1] and with_grad.grad_fn is not None
    np.testing.assert_allclose(with_grad.detach().numpy(), got, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("H,W,ok", [
    (28, 28, True), (64, 64, True), (12, 20, True), (32, 32, True),
    (8, 8, True), (1, 127, True), (64, 65, False), (100, 40, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gates(H, W, ok, dtype):
    """The kernels' gates as pure predicates, checked without a build:
    every grid with H + W <= 128 at head width 64; and the routes raise
    ``ValueError`` outside them before anything is built (the bf16-only
    routes ``TypeError`` for fp32)."""
    from classpose_tpu_torch.nn.attention import (
        _check_kernel, _grid_supported, _hm_kernel)

    dt = getattr(torch, dtype)
    bf16 = dt == torch.bfloat16
    assert _grid_supported(64, H, W) == ok
    for hd in (32, 128):
        assert not _grid_supported(hd, H, W)
    L = H * W
    qkv = torch.zeros(1, L, 3 * 64, dtype=dt)
    rel = torch.zeros(1, L, 1, H + W, dtype=dt)
    if not bf16:
        with pytest.raises(TypeError, match="bf16"):
            _check_kernel(qkv, rel, 64, L, H, W)
    if ok:
        return
    q = torch.zeros(1, 1, L, 64, dtype=dt)
    with pytest.raises(ValueError, match="H\\+W <= 128"):
        _hm_kernel(q, q, q, torch.zeros(1, 1, L, H, dtype=dt),
                   torch.zeros(1, 1, L, W, dtype=dt), 0.125, (H, W))
    if bf16:
        with pytest.raises(ValueError, match="H\\+W <= 128"):
            _check_kernel(qkv, rel, 64, L, H, W)
