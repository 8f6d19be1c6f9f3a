"""Port masked diffusion (plain version of the CUDA kernel) against the
JAX resident Pallas kernel in interpret mode and the XLA stencil
``_diffuse_dyn``: bitwise, including per-tile iteration counts."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from classpose_tpu.dynamics.flows import _diffuse_dyn as jax_diffuse
from classpose_tpu.ops.diffusion_pallas import diffuse_resident_pallas
from classpose_tpu_torch.dynamics.flows import _diffuse_dyn
from classpose_tpu_torch.ops.diffusion import masked_diffusion

H, W = 64, 128


def _blob_field(n, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((H, W), np.int32)
    center = np.zeros((H, W), np.float32)
    for k in range(1, n + 1):
        cy, cx = rng.integers(2, H - 2), rng.integers(2, W - 2)
        r = int(rng.integers(2, 6))
        yy, xx = np.ogrid[:H, :W]
        ids[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
        center[cy, cx] = 1.0
    ids[0, :5] = 99  # instance touching the image border
    return ids, center


def test_matches_resident_pallas_bitwise_per_tile_niter():
    tiles = [_blob_field(10, s) for s in range(3)]
    ids = np.stack([t[0] for t in tiles])
    cen = np.stack([t[1] for t in tiles])
    niters = np.array([5, 17, 40], np.int32)
    ref = np.asarray(jax.vmap(
        lambda i, c, n: diffuse_resident_pallas(i, c, n, interpret=True)
    )(jnp.asarray(ids), jnp.asarray(cen), jnp.asarray(niters)))
    got = masked_diffusion(torch.from_numpy(ids), torch.from_numpy(cen),
                           torch.from_numpy(niters)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_matches_xla_stencil_bitwise():
    ids, cen = _blob_field(12, 5)
    for niter in (1, 7, 40):
        ref = np.asarray(jax_diffuse(jnp.asarray(ids), jnp.asarray(cen),
                                     jnp.int32(niter)))
        got = _diffuse_dyn(torch.from_numpy(ids), torch.from_numpy(cen),
                           niter).numpy()
        np.testing.assert_array_equal(got, ref)


def test_zero_iterations_is_zero():
    ids, cen = _blob_field(3, 1)
    got = masked_diffusion(torch.from_numpy(ids)[None],
                           torch.from_numpy(cen)[None],
                           torch.zeros(1, dtype=torch.int32))
    assert not got.any()
