"""The whole slice: JAX ``ClassposeModel.eval_batch`` against the port's
on the same ``.npz`` checkpoint (written by the JAX ``save_params``, read
by the port's own reader), 2 uint8 tiles of 128², niter 40, fp32.

Masks are compared as masks. Exact equality is expected wherever the
sampler paths coincide, but it is not required: below 384² the JAX CPU
path samples with ``_bilinear2``'s flat four-corner sum while the port
uses the TPU kernel's factored order, and the flow composition can
amplify those last-bit differences at a basin boundary."""

import numpy as np
import pytest

from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.runner import ClassposeModel as JaxModel
from classpose_tpu_torch.runner import ClassposeModel
from golden.jax_native import jax_native_geometry  # noqa: F401

CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
           neck_dim=64, bsize=64)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    cfg = JaxCfg(**CFG)
    params = perturbed_structured_params(cfg, ripple=0.5, seed=0)
    path = str(tmp_path_factory.mktemp("ck") / "slice.npz")
    save_params(params, path, cfg=cfg)
    tiles = np.random.default_rng(1).uniform(
        0, 255, size=(2, 128, 128, 3)).astype(np.uint8)
    kw = dict(batch_size=8, niter=40)
    ref = JaxModel(pretrained_model=path, precision="fp32").eval_batch(
        tiles, **kw)
    got = ClassposeModel(pretrained_model=path, precision="fp32",
                         device="cpu").eval_batch(tiles, **kw)
    return ref, got


def _match(ma, mb):
    """Pair instances of two label maps by IoU; returns [(a, b, iou)]."""
    pairs = []
    for a in range(1, int(ma.max()) + 1):
        sel = ma == a
        ids, cnt = np.unique(mb[sel], return_counts=True)
        cnt, ids = cnt[ids > 0], ids[ids > 0]
        if not len(ids):
            pairs.append((a, 0, 0.0))
            continue
        b = ids[np.argmax(cnt)]
        inter = cnt.max()
        pairs.append((a, b, inter / (sel.sum() + (mb == b).sum() - inter)))
    return pairs


def test_slice_masks_match(results):
    ref, got = results
    for (m_ref, _), (m, _) in zip(ref, got):
        assert m.dtype == np.int32 and m.shape == m_ref.shape
        assert m_ref.max() >= 10  # the designed cells were found
        assert m.max() == m_ref.max()
        pairs = _match(m_ref, m)
        assert min(iou for _, _, iou in pairs) >= 0.95
        assert len({b for _, b, _ in pairs}) == len(pairs)
        assert ((m > 0) == (m_ref > 0)).mean() >= 0.995


def test_slice_classes_match(results):
    ref, got = results
    for (m_ref, c_ref), (m, c) in zip(ref, got):
        assert c.dtype == np.int32
        for a, b, _ in _match(m_ref, m):
            assert c_ref[m_ref == a][0] == c[m == b][0]
        assert (c[m == 0] == 0).all()
