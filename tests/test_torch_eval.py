"""The per-image API: the port's ``ClassposeModel.eval`` against the JAX
``ClassposeModel.eval`` on the same ``.npz`` checkpoint (a tiny config,
fp32, the CPU), and the resize with ``jax.image.resize`` semantics.

Tolerances: flows and cellprob to 1e-4 (fp32 networks whose sums run in
another order); masks compared as masks (equal counts, every instance
matched at IoU ≥ 0.9, ≥ 99% pixel agreement): the JAX CPU path samples
flows below 384² with ``_bilinear2``'s flat four-corner sum, the port in
the TPU kernel's factored order, and the flow composition can move a
basin-boundary pixel. ``dx_to_circ`` is equal to the bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.runner import ClassposeModel as JaxModel
from classpose_tpu.runner.model import convert_image as jax_convert
from classpose_tpu.runner.model import dx_to_circ as jax_circ
from classpose_tpu.runner.run3d import stitch3D as jax_stitch
from classpose_tpu_torch.ops.resize import resize
from classpose_tpu_torch.runner import ClassposeModel
from classpose_tpu_torch.runner.model import convert_image, dx_to_circ
from classpose_tpu_torch.runner.run3d import stitch3D
from golden.jax_native import jax_native_geometry  # noqa: F401

CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
           neck_dim=64, bsize=64)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    cfg = JaxCfg(**CFG)
    path = str(tmp_path_factory.mktemp("ck") / "eval.npz")
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0), path,
                cfg=cfg)
    return (JaxModel(pretrained_model=path, precision="fp32"),
            ClassposeModel(pretrained_model=path, precision="fp32",
                           device="cpu"))


def _image(H, W, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 255, size=(H, W, 3)).astype(np.float32)


def _match(ma, mb):
    """Pair instances of two label maps by IoU; returns [(a, b, iou)]."""
    pairs = []
    for a in range(1, int(ma.max()) + 1):
        sel = ma == a
        if not sel.any():
            continue
        ids, cnt = np.unique(mb[sel], return_counts=True)
        cnt, ids = cnt[ids > 0], ids[ids > 0]
        if not len(ids):
            pairs.append((a, 0, 0.0))
            continue
        b = ids[np.argmax(cnt)]
        inter = cnt.max()
        pairs.append((a, b, inter / (sel.sum() + (mb == b).sum() - inter)))
    return pairs


def _same_masks(m, m_ref, min_cells=3):
    assert m.shape == m_ref.shape and m.dtype == np.int32
    n, n_ref = len(np.unique(m)) - 1, len(np.unique(m_ref)) - 1
    assert n_ref >= min_cells and n == n_ref
    pairs = _match(m_ref, m)
    assert min(iou for _, _, iou in pairs) >= 0.9
    assert ((m > 0) == (m_ref > 0)).mean() >= 0.99
    return pairs


def _compare(ref, got, flows_tol=1e-4):
    (m_ref, f_ref, c_ref, s_ref), (m, f, c, s) = ref, got
    pairs = _same_masks(m, m_ref)
    for a, b, _ in pairs:
        assert c_ref[m_ref == a][0] == c[m == b][0]
    assert (c[m == 0] == 0).all()
    for i in (1, 2, 3):  # dP, cellprob, y_class
        assert f[i].shape == np.asarray(f_ref[i]).shape
        np.testing.assert_allclose(f[i], np.asarray(f_ref[i]),
                                   atol=flows_tol, rtol=flows_tol)
    assert tuple(f[4]) == tuple(f_ref[4])
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=1e-6)


@pytest.mark.parametrize("H,W,kw", [
    (128, 128, {}),
    (100, 150, {}),
    (128, 128, {"diameter": 20.0}),             # upsampled 1.5×
    (150, 120, {"diameter": 45.0}),             # downsampled, antialiased
    (96, 96, {"augment": True}),
    (128, 128, {"normalize": {"tile_norm_blocksize": 64}}),
    (128, 128, {"diameter": 20.0, "resample": False}),
])
def test_eval_matches_jax(models, H, W, kw):
    jm, tm = models
    x = _image(H, W)
    ref = jm.eval(x, batch_size=4, niter=40, **kw)
    got = tm.eval(x, batch_size=4, niter=40, **kw)
    _compare(ref, got)


def test_eval_list_and_no_masks(models):
    jm, tm = models
    xs = [_image(96, 96, s) for s in (2, 3)]
    got = tm.eval(xs, batch_size=4, niter=40)
    assert len(got[0]) == 2 and len(tm.timing) == 2
    for i, x in enumerate(xs):
        _same_masks(got[0][i], jm.eval(x, batch_size=4, niter=40)[0])
    m, flows, cm, _ = tm.eval(xs[0], compute_masks=False)
    assert m.size == 0 and cm.size == 0 and flows[1].shape == (2, 96, 96)


def test_dx_to_circ_and_convert_image_equal():
    rng = np.random.default_rng(0)
    dP = rng.normal(size=(2, 40, 50)).astype(np.float32)
    np.testing.assert_array_equal(dx_to_circ(dP), jax_circ(dP))
    for x, ax in ((rng.uniform(size=(20, 30)), None),
                  (rng.uniform(size=(2, 20, 30)), None),
                  (rng.uniform(size=(20, 30, 5)), None),
                  (rng.uniform(size=(20, 4, 30)), 1)):
        np.testing.assert_array_equal(convert_image(x, ax),
                                      jax_convert(x, ax))


@pytest.mark.parametrize("method,shape,out", [
    ("linear", (3, 100, 80), (3, 150, 60)),     # up along y, down along x
    ("linear", (37, 53), (12, 20)),             # down, antialiased
    ("linear", (2, 5, 6, 4), (2, 40, 30, 4)),   # up 8×/5×
    ("nearest", (100, 80), (150, 61)),
    ("nearest", (3, 37, 53), (3, 12, 20)),
    ("nearest", (192, 128), (128, 192)),
])
def test_resize_matches_jax_image_resize(method, shape, out):
    """Half-pixel centres, the antialiased triangle when downsampling,
    normalized weights; nearest by floor((i + 0.5)·in/out). Linear to
    1e-4 of values ~N(0, 1) (JAX's dense f32 einsum rounds more than the
    port's banded sum). Nearest exact with integers kept, except at
    exact ties ((i + 0.5)·in/out an integer), where JAX's float32
    division on the CPU rounds either way and the port takes the exact
    value."""
    rng = np.random.default_rng(0)
    if method == "nearest":
        x = rng.integers(0, 1000, size=shape).astype(np.int32)
    else:
        x = rng.normal(size=shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(torch.from_numpy(x), out, method).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if method == "nearest":
        keep = np.ones(out, bool)
        for d, (m, n) in enumerate(zip(shape, out)):
            i = np.arange(n)
            tie = ((2 * i + 1) * m) % (2 * n) == 0
            sl = [None] * len(out)
            sl[d] = slice(None)
            keep &= ~tie[tuple(sl)] if m != n else True
            exact = np.floor((i + 0.5) * m / n).astype(int)
            np.testing.assert_array_equal(
                np.asarray(resize(torch.arange(m), (n,), "nearest")), exact)
        np.testing.assert_array_equal(got[keep], ref[keep])
        assert keep.mean() > 0.5
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4)
        naive = torch.nn.functional.interpolate(
            torch.from_numpy(x).reshape(1, -1, *shape[-2:]),
            size=out[-2:], mode="bilinear", align_corners=False).numpy()
        if np.prod(out[-2:]) < np.prod(shape[-2:]) and x.ndim == 2:
            # F.interpolate does not antialias: it is not this resize
            assert np.abs(naive.reshape(got.shape) - ref).max() > 1e-2


def test_stitch3d_matches_jax():
    rng = np.random.default_rng(3)
    planes = []
    base = np.zeros((40, 40), np.int32)
    for k, (cy, cx) in enumerate([(8, 8), (20, 25), (32, 10)], start=1):
        base[cy - 5:cy + 5, cx - 5:cx + 5] = k
    for z in range(5):
        p = np.roll(base, z, axis=1).copy()
        if z == 2:
            p[rng.uniform(size=p.shape) < 0.3] = 0
            p[30:38, 30:38] = 9
        planes.append(p)
    planes.insert(3, np.zeros((40, 40), np.int32))
    stack = np.stack(planes)
    for thr in (0.25, 0.6):
        np.testing.assert_array_equal(stitch3D(stack, thr),
                                      jax_stitch(stack, thr))


@pytest.mark.parametrize("mode", ["do_3D", "stitch"])
def test_eval_3d_matches_jax(models, mode):
    jm, tm = models
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 255, size=(6, 64, 64, 3)).astype(np.float32)
    kw = ({"do_3D": True} if mode == "do_3D"
          else {"stitch_threshold": 0.25})
    ref = jm.eval(x, batch_size=4, niter=16, **kw)
    got = tm.eval(x, batch_size=4, niter=16, **kw)
    m, m_ref = got[0], ref[0]
    assert m.shape == m_ref.shape == (6, 64, 64)
    assert m_ref.max() > 0
    np.testing.assert_allclose(got[1][1], np.asarray(ref[1][1]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got[1][2], np.asarray(ref[1][2]), atol=1e-4,
                               rtol=1e-4)
    assert len(np.unique(m)) == len(np.unique(m_ref))
    assert ((m > 0) == (m_ref > 0)).mean() >= 0.99
    for a, b, iou in _match(m_ref, m):
        assert iou >= 0.9
        assert got[2][m == b][0] == ref[2][m_ref == a][0]
