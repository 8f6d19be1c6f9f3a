"""Port normalization and tiling against the JAX package (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.ops import normalize as jn
from classpose_tpu.ops import tiles as jt
from classpose_tpu_torch.ops import normalize as tn
from classpose_tpu_torch.ops import tiles as tt


@pytest.mark.parametrize("kw", [
    dict(integral_stats=True),
    dict(integral_stats=True, invert=True, percentile=(5.0, 95.0)),
    dict(),
    dict(percentile_subsample=2),
    dict(lowhigh=(10.0, 200.0)),
    dict(sharpen_radius=2),
])
def test_normalize_img(kw):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(96, 80, 3)).astype(np.float32)
    img[..., 1] = np.clip(img[..., 1] * 0.3 + 40, 0, 255).round()
    ref = np.asarray(jn.normalize_img(jnp.asarray(img), axis=-1, **kw))
    got = tn.normalize_img(torch.from_numpy(img), axis=-1, **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _grid_and_img(S, bsize, augment):
    pads = jt.get_pad_yx(S, S, (bsize, bsize))
    assert pads == tt.get_pad_yx(S, S, (bsize, bsize))
    Sp = S + pads[0] + pads[1]
    g_j = jt.compute_tile_grid(Sp, Sp, bsize, 0.1, augment)
    g_t = tt.compute_tile_grid(Sp, Sp, bsize, 0.1, augment)
    assert (g_j.ny, g_j.nx, g_j.ystart, g_j.xstart) == (
        g_t.ny, g_t.nx, g_t.ystart, g_t.xstart)
    img = np.random.default_rng(1).normal(size=(3, Sp, Sp)).astype(np.float32)
    return g_j, g_t, img


@pytest.mark.parametrize("S,bsize,augment", [
    (1024, 256, False), (150, 64, False), (150, 64, True), (40, 64, False),
])
def test_tiles_roundtrip(S, bsize, augment):
    g_j, g_t, img = _grid_and_img(S, bsize, augment)
    t_ref = np.asarray(jt.make_tiles(jnp.asarray(img), g_j))
    t_got = tt.make_tiles(torch.from_numpy(img), g_t).numpy()
    np.testing.assert_array_equal(t_got, t_ref)
    rng = np.random.default_rng(2)
    y = rng.normal(size=(g_t.ntiles, 3, bsize, bsize)).astype(np.float32)
    for fj, ft in ((jt.unaugment_tiles, tt.unaugment_tiles),
                   (jt.unaugment_class_tiles, tt.unaugment_class_tiles)):
        np.testing.assert_array_equal(
            ft(torch.from_numpy(y), g_t).numpy(),
            np.asarray(fj(jnp.asarray(y), g_j)))
    for fj, ft in ((jt.average_tiles_separable, tt.average_tiles_separable),
                   (jt.average_tiles, tt.average_tiles)):
        ref = np.asarray(fj(jnp.asarray(y), g_j))
        got = ft(torch.from_numpy(y), g_t).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_tiles_batched_leading_dim():
    """The port takes a leading batch dim; each slice equals the
    unbatched call."""
    _, g_t, img = _grid_and_img(300, 128, False)
    imgs = torch.from_numpy(np.stack([img, 2 * img]))
    t = tt.make_tiles(imgs, g_t)
    avg = tt.average_tiles_separable(t, g_t)
    for b in range(2):
        np.testing.assert_array_equal(
            avg[b].numpy(), tt.average_tiles_separable(t[b], g_t).numpy())
