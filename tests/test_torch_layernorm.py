"""Kernel 6's plain version and dispatch against the JAX package:
``layernorm_ref`` against the JAX ``layernorm_ref`` (fp32, 1e-6) and
against ``layernorm_pallas`` in interpret mode (bf16, the JAX kernel
test's tolerance), and the ``CLASSPOSE_LN_PALLAS`` switch, which on the
CPU always takes the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn.layernorm import layernorm_pallas
from classpose_tpu.nn.layernorm import layernorm_ref as jax_ref
from classpose_tpu_torch import _build
from classpose_tpu_torch.nn import ClassTransformer, ClassTransformerConfig
from classpose_tpu_torch.nn.layernorm import (
    layernorm,
    layernorm_cuda,
    layernorm_ref,
    layernorm_supported,
    ln_kernel_on,
)


def _inputs(shape, seed=0):
    """``normal·3 + 0.5`` as ``tests/test_layernorm.py`` draws them, and
    random fp32 affine parameters."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * 3 + 0.5
    C = shape[-1]
    return (x, rng.normal(size=(C,)).astype(np.float32),
            rng.normal(size=(C,)).astype(np.float32))


@pytest.mark.parametrize("fast_var", [True, False])
@pytest.mark.parametrize("shape", [(4, 9, 1024), (3, 8, 8, 256), (5, 96)])
def test_ref_matches_jax_fp32(shape, fast_var):
    x, w, b = _inputs(shape)
    got = layernorm_ref(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), fast_var=fast_var).numpy()
    ref = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             fast_var=fast_var))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,fast_var", [((2, 7, 32, 32, 1024), True),
                                            ((25, 64, 64, 256), False)])
def test_ref_matches_pallas_kernel_bf16(shape, fast_var):
    """bf16 outputs of fp32 math summed in another order: the JAX kernel
    test's atol 0.06, rtol 0.02."""
    x, w, b = _inputs(shape)
    xj = jnp.asarray(x, jnp.bfloat16)
    pal = np.asarray(layernorm_pallas(
        xj, jnp.asarray(w), jnp.asarray(b), fast_var=fast_var,
        interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = layernorm_ref(xt, torch.from_numpy(w), torch.from_numpy(b),
                        fast_var=fast_var)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pal, atol=0.06,
                               rtol=0.02)


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("off", False), ("1", True),
                                      ("on", True), ("interpret", False)])
def test_switch_values(monkeypatch, value, on):
    """The JAX package's values: 1/on take the kernel; unset, off and
    interpret (the JAX CPU test mode) take the plain version."""
    if value is None:
        monkeypatch.delenv("CLASSPOSE_LN_PALLAS", raising=False)
    else:
        monkeypatch.setenv("CLASSPOSE_LN_PALLAS", value)
    assert ln_kernel_on() is on


def test_supported_shapes():
    bf = torch.bfloat16
    assert layernorm_supported(torch.zeros(3, 1024, dtype=bf))
    assert layernorm_supported(torch.zeros(7, 128, dtype=bf))
    assert layernorm_supported(torch.zeros(1, 2048, dtype=bf))
    assert not layernorm_supported(torch.zeros(3, 1024))  # fp32
    assert not layernorm_supported(torch.zeros(3, 96, dtype=bf))
    assert not layernorm_supported(torch.zeros(3, 4096, dtype=bf))


def test_cpu_tensor_takes_plain_version_with_switch_on(monkeypatch):
    """On the CPU the wrapper runs the plain version, whatever the
    switch, and launches nothing; a tensor that needs a gradient is
    fine there (the kernel route alone has no backward)."""
    monkeypatch.setenv("CLASSPOSE_LN_PALLAS", "1")
    x, w, b = (torch.from_numpy(a) for a in _inputs((6, 256)))
    x = x.to(torch.bfloat16).requires_grad_()
    _build.reset_launches()
    y = layernorm(x, w, b, fast_var=False)
    assert _build.LAUNCHES["layernorm"] == 0
    assert torch.equal(y, layernorm_ref(x, w, b, fast_var=False))
    y.float().sum().backward()
    assert x.grad is not None


def test_kernel_wrapper_refuses_cpu_tensor():
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_cuda(x, torch.ones(256), torch.zeros(256))


def test_vit_forward_unchanged_by_switch(monkeypatch):
    """The ViT forward on the CPU is the same with the switch off, on or
    in interpret mode (all plain), and its LayerNorms are the plain
    version's."""
    cfg = ClassTransformerConfig(embed_dim=128, depth=2, num_heads=2,
                                 neck_dim=128, bsize=64, n_cell_classes=3,
                                 dtype="bfloat16")
    torch.manual_seed(0)
    net = ClassTransformer(cfg).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 3, 64, 64)).astype(np.float32))
    outs = []
    for value in (None, "1", "interpret"):
        if value is None:
            monkeypatch.delenv("CLASSPOSE_LN_PALLAS", raising=False)
        else:
            monkeypatch.setenv("CLASSPOSE_LN_PALLAS", value)
        with torch.no_grad():
            outs.append(net(x)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    blk = net.encoder.blocks[0]
    t = torch.randn(2, 4, 4, 128).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(blk.norm1(t), layernorm_ref(
            t, blk.norm1.weight, blk.norm1.bias))
