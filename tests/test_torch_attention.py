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
from classpose_tpu_torch.nn.attention import attention_relpos

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
