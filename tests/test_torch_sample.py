"""Port sampler and landing histogram (plain versions of the CUDA
kernels) against the JAX Pallas stripe kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.dynamics.masks import _bilinear2
from classpose_tpu.ops.sample_pallas import (
    scatter_count_pallas,
    shift_sample_pallas,
)
from classpose_tpu_torch.ops.sample import bilinear_sample, landing_histogram

H, W = 64, 128


def _positions(rng, max_disp=2.5):
    gy = np.arange(H, dtype=np.float32)[:, None] + np.zeros((1, W), np.float32)
    gx = np.arange(W, dtype=np.float32)[None, :] + np.zeros((H, 1), np.float32)
    py = np.clip(gy + rng.uniform(-max_disp, max_disp, (H, W)), 0, H - 1)
    px = np.clip(gx + rng.uniform(-max_disp, max_disp, (H, W)), 0, W - 1)
    return py.astype(np.float32), px.astype(np.float32)


def _int_targets(rng):
    fy = np.clip(np.arange(H)[:, None] + rng.integers(-3, 4, (H, W)),
                 0, H - 1).astype(np.int32)
    fx = np.clip(np.arange(W)[None, :] + rng.integers(-3, 4, (H, W)),
                 0, W - 1).astype(np.int32)
    return fy, fx


@pytest.mark.parametrize("seed", [0, 1])
def test_sampler_matches_pallas_factored_order(seed):
    """Same factored two-level lerp as the Pallas kernel: within 1e-6
    (bitwise where the CPU backends order the products the same)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(1, 2, H, W)).astype(np.float32)
    py, px = _positions(rng)
    ref = np.asarray(shift_sample_pallas(
        jnp.asarray(u), jnp.asarray(py)[None], jnp.asarray(px)[None],
        D=4, interpret=True))
    got = bilinear_sample(torch.from_numpy(u), torch.from_numpy(py)[None],
                          torch.from_numpy(px)[None]).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_sampler_matches_flat_bilinear():
    rng = np.random.default_rng(2)
    u = rng.normal(size=(2, H, W)).astype(np.float32)
    py, px = _positions(rng)
    ref = np.stack([np.asarray(a) for a in _bilinear2(
        jnp.asarray(u), jnp.asarray(py), jnp.asarray(px))])
    got = bilinear_sample(torch.from_numpy(u)[None],
                          torch.from_numpy(py)[None],
                          torch.from_numpy(px)[None]).numpy()[0]
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_sampler_c1_integer_positions_exact():
    """The get_masks label lookup: C=1 at integer positions is an exact
    gather, in the port and in the Pallas kernel."""
    rng = np.random.default_rng(1)
    lab = rng.integers(0, 5000, size=(H, W)).astype(np.float32)
    fy, fx = _int_targets(rng)
    pal = np.asarray(shift_sample_pallas(
        jnp.asarray(lab)[None, None], jnp.asarray(fy, jnp.float32)[None],
        jnp.asarray(fx, jnp.float32)[None], D=4, interpret=True))[0, 0]
    np.testing.assert_array_equal(pal, lab[fy, fx])
    fy[0, :4] = H - 1  # bottom/right edge rows take the y0 = H-2 clip
    fx[0, :4] = W - 1
    got = bilinear_sample(
        torch.from_numpy(lab)[None, None],
        torch.from_numpy(fy.astype(np.float32))[None],
        torch.from_numpy(fx.astype(np.float32))[None]).numpy()[0, 0]
    np.testing.assert_array_equal(got, lab[fy, fx])


def test_histogram_matches_pallas_exact():
    rng = np.random.default_rng(2)
    fy, fx = _int_targets(rng)
    cell = (rng.uniform(size=(H, W)) < 0.7).astype(np.float32)
    ref = np.asarray(scatter_count_pallas(
        jnp.asarray(fy)[None], jnp.asarray(fx)[None],
        jnp.asarray(cell)[None], D=4, interpret=True))
    got = landing_histogram(torch.from_numpy(fy)[None],
                            torch.from_numpy(fx)[None],
                            torch.from_numpy(cell)[None]).numpy()
    np.testing.assert_array_equal(got, ref)


def test_histogram_edge_landing_exact():
    fy = np.zeros((2, H, W), np.int32)
    fx = np.broadcast_to(np.arange(W, dtype=np.int32), (2, H, W)).copy()
    cell = np.ones((2, H, W), np.float32)
    cell[:, 4:] = 0.0
    ref = np.asarray(scatter_count_pallas(
        jnp.asarray(fy), jnp.asarray(fx), jnp.asarray(cell), D=4,
        interpret=True))
    got = landing_histogram(torch.from_numpy(fy), torch.from_numpy(fx),
                            torch.from_numpy(cell)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 0] == 4.0).all() and got[:, 1:].sum() == 0


def test_wrappers_check_dtypes():
    with pytest.raises(TypeError):
        landing_histogram(torch.zeros(1, 4, 4), torch.zeros(1, 4, 4),
                          torch.zeros(1, 4, 4))
    with pytest.raises(TypeError):
        bilinear_sample(torch.zeros(1, 1, 4, 4, dtype=torch.float64),
                        torch.zeros(1, 4, 4), torch.zeros(1, 4, 4))
