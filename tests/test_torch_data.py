"""Port training data path against the JAX package: flow targets
(``labels_to_flows``, ``process_train_test``), the cv2-free augmentation,
the samplers, the host helpers, and the native ``.npz`` weights in both
directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.dynamics import flows as jax_flows
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import flatten_params
from classpose_tpu.runner import ClassposeModel as JaxModel
from classpose_tpu.train import augment as jax_augment
from classpose_tpu.train import samplers as jax_samplers
from classpose_tpu.train import train_utils as jax_tu
from classpose_tpu.utils import make_sparse as jax_make_sparse
from classpose_tpu_torch.dynamics import flows as port_flows
from classpose_tpu_torch.nn import ClassTransformer, ClassTransformerConfig
from classpose_tpu_torch.nn.convert import (
    load_into,
    params_from_jax,
    params_to_jax,
    save_params,
)
from classpose_tpu_torch.train import augment as port_augment
from classpose_tpu_torch.train import samplers as port_samplers
from classpose_tpu_torch.train import train_utils as port_tu
from classpose_tpu_torch.utils import make_sparse

from test_torch_nn import TINY, _random_jax_params
from golden.jax_native import jax_native_geometry  # noqa: F401


def disc_sample(seed, H=96, W=96, n=6, n_classes=4):
    """(image (3, H, W), label (2, H, W) [instance, class]) of random
    discs, as tests/test_training.py draws them."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((H, W), np.float32)
    cls = np.zeros((H, W), np.float32)
    yy, xx = np.mgrid[:H, :W]
    k = 0
    for _ in range(n):
        r = rng.integers(6, 14)
        cy, cx = rng.integers(r, H - r), rng.integers(r, W - r)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (inst == 0)
        if m.sum() < 10:
            continue
        k += 1
        inst[m] = k
        cls[m] = rng.integers(1, n_classes)
    img = (np.stack([200 - 50 * (inst > 0)] * 3)
           + rng.uniform(0, 40, (3, H, W))).astype(np.float32)
    return img, np.stack([inst, cls])


# ------------------------------------------------------------ flow targets

def assert_targets_match(got, ref):
    """(C, H, W) targets whose first channel is the dense instance map and
    last two the flows: every other channel bitwise equal, flows to 1e-6
    off the instance centres. Why not bitwise: the diffused T is bitwise
    equal (same centres, same term order, the plain diffusion multiplying
    by float32(1/9) as XLA compiles the JAX ``/ 9.0``), but torch's and
    XLA's float32 ``log1p`` differ by one ulp on ~1.5% of pixels. Off the
    centres that moves the unit flow by a few ulps; at each centre, the
    diffusion's fixed point, both central differences are at rounding
    level and the normalized direction is arbitrary in either package."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got[:-2], ref[:-2])
    off = port_flows.instance_center_map(ref[0].astype(np.int32)) == 0
    np.testing.assert_allclose(got[-2:][:, off], ref[-2:][:, off], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_to_flows_matches_jax(seed):
    _, lab = disc_sample(seed, H=80, W=112)
    ids = lab[0].copy()
    ids[ids == 3] = 17  # a non-dense id, densified by both
    got = port_flows.labels_to_flows(ids, device="cpu")
    ref = jax_flows.labels_to_flows(ids)
    assert_targets_match(got, ref)
    dense = ref[0].astype(np.int32)
    cen = port_flows.instance_center_map(dense)
    np.testing.assert_array_equal(cen, jax_flows.instance_center_map(dense))
    T = port_flows._diffuse_dyn(torch.from_numpy(dense),
                                torch.from_numpy(cen), 100).numpy()
    np.testing.assert_array_equal(
        T, np.asarray(jax_flows._diffuse_dyn(jnp.asarray(dense),
                                             jnp.asarray(cen), 100)))


def test_labels_to_flows_empty_and_extent():
    z = np.zeros((16, 24), np.int32)
    np.testing.assert_array_equal(port_flows.labels_to_flows(z, device="cpu"),
                                  jax_flows.labels_to_flows(z))
    _, lab = disc_sample(5)
    m = lab[0].astype(np.int32)
    assert port_flows._max_instance_extent(m) == \
        jax_flows._max_instance_extent(m)
    for v in (1, 49, 50, 51, 1199):
        assert port_flows._bucket(v, 50) == jax_flows._bucket(v, 50)


def test_process_train_test_equal():
    samples = [disc_sample(i) for i in range(5)]
    data = [s[0] for s in samples]
    labels = [s[1] for s in samples]
    labels[1] = labels[1].copy()
    labels[1][1][labels[1][0] == 2] = 0  # unannotated class pixels → −100
    labels[4] = np.zeros_like(labels[4])  # no masks: filtered out
    got = port_tu.process_train_test(data, labels, data[:2], labels[:2],
                                     min_train_masks=2, device="cpu")
    ref = jax_tu.process_train_test(data, labels, data[:2], labels[:2],
                                    min_train_masks=2)
    assert len(got[0]) == len(ref[0]) == 4
    for g, r in zip(got, ref):
        assert len(g) == len(r)
    for i in (0, 2, 3, 5):  # images and diameters
        for a, b in zip(got[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    for i in (1, 4):  # (5, H, W) targets [instance, class, binary, fy, fx]
        for a, b in zip(got[i], ref[i]):
            assert_targets_match(a, b)


def test_train_utils_helpers_equal():
    samples = [disc_sample(i) for i in range(6)]
    Y = np.stack([s[1] for s in samples])
    X = np.stack([s[0] for s in samples])
    counts = jax_tu.get_class_counts(Y[:, 1], 4)
    np.testing.assert_array_equal(port_tu.get_class_counts(Y[:, 1], 4),
                                  counts)
    np.testing.assert_array_equal(port_tu.get_class_weights(counts),
                                  jax_tu.get_class_weights(counts))
    inst = np.random.default_rng(0).integers(0, 5, (6, 4))
    np.testing.assert_array_equal(
        port_tu.compute_oversampling_probabilities(counts, inst, 2.0),
        jax_tu.compute_oversampling_probabilities(counts, inst, 2.0))
    for a, b in zip(port_tu.oversample_classes(X, Y, 2, seed=3),
                    jax_tu.oversample_classes(X, Y, 2, seed=3)):
        np.testing.assert_array_equal(a, b)
    assert port_tu.diameters(Y[0, 0]) == jax_tu.diameters(Y[0, 0])
    lab = np.stack([Y[0, 1], Y[0, 0]])  # (class, instance)
    np.testing.assert_array_equal(
        make_sparse(lab, 0.5, np.random.default_rng(1)),
        jax_make_sparse(lab, 0.5, np.random.default_rng(1)))


# ------------------------------------------------------------ augmentation

@pytest.mark.parametrize("seed,rescale", [(0, 0.8), (1, 1.3), (2, 1.0)])
def test_augmentation_matches_cv2(seed, rescale):
    """The scipy warp against the JAX package's cv2 warp, under the same
    numpy draws. Tolerance: OpenCV's bilinear warp may place each source
    position on a 1/32-pixel grid (its fixed-point INTER_BITS = 5), an
    error of ≤ 1/64 pixel per axis, so a bilinear channel may differ by
    ≤ (1/32)·(its largest step between neighbouring pixels); nearest
    sampling of the class channel may flip a pixel whose position lies
    within that error of a pixel edge, so ≥ 99% must agree. (The OpenCV
    build here samples at float positions: the differences it shows are
    ~1e-5 of a step and none of the class pixels.)"""
    img, lab = disc_sample(seed, H=128, W=128)
    ang = np.random.default_rng(seed).uniform(0, 2 * np.pi, lab[0].shape)
    fg = (lab[0] > 0).astype(np.float32)
    lbl = np.stack([lab[1], fg, np.sin(ang) * fg, np.cos(ang) * fg]
                   ).astype(np.float32)
    lbl[0, :6, :6] = -100
    got = port_augment.random_rotate_and_resize(
        img, lbl, rescale=rescale, xy=(64, 64),
        rng=np.random.default_rng(seed))
    ref = jax_augment.random_rotate_and_resize(
        img, lbl, rescale=rescale, xy=(64, 64),
        rng=np.random.default_rng(seed))
    assert got[2] == ref[2]
    assert got[0].shape == ref[0].shape == (3, 64, 64)
    assert got[1].shape == ref[1].shape == (4, 64, 64)
    assert (got[1][0] == ref[1][0]).mean() >= 0.99

    def step(a):
        return max(np.abs(np.diff(a, axis=-1)).max(),
                   np.abs(np.diff(a, axis=-2)).max())

    for a, b, src in [(got[0], ref[0], img)] + [
            (got[1][k], ref[1][k], lbl[k]) for k in (1, 2, 3)]:
        assert np.abs(a - b).max() <= step(src) / 32 + 1e-6


# ---------------------------------------------------------------- samplers

@pytest.mark.parametrize("n,bs,world,probs,per_epoch", [
    (64, 4, 2, False, None),
    (30, 3, 1, False, 20),
    (40, 2, 4, True, 48),
])
def test_samplers_equal(n, bs, world, probs, per_epoch):
    p = (np.random.default_rng(n).uniform(0, 1, n) if probs else None)
    for rank in range(world):
        kw = dict(dataset_length=n, batch_size=bs, train_probs=p,
                  nimg_per_epoch=per_epoch, rank=rank, num_replicas=world,
                  seed=7)
        a = port_samplers.DistributedEpochSampler(**kw)
        b = jax_samplers.DistributedEpochSampler(**kw)
        assert len(a) == len(b)
        for epoch in range(3):
            np.testing.assert_array_equal(a.local_indices(epoch),
                                          b.local_indices(epoch))
        a.set_epoch(5)
        b.set_epoch(5)
        assert list(a) == list(b)
        assert port_samplers.SequentialDistributedSampler(
            n, rank, world).indices() == \
            jax_samplers.SequentialDistributedSampler(
                n, rank, world).indices()
    with pytest.raises(ValueError, match="full distributed batch"):
        port_samplers.DistributedEpochSampler(3, 4, num_replicas=2)


# ----------------------------------------------------------------- weights

def test_params_to_jax_round_trip():
    cfg = JaxCfg(**{**TINY, "feature_transformation_structure": (8, 16)})
    _, params = _random_jax_params(cfg)
    flat = flatten_params(params)
    back = params_to_jax(params_from_jax(params))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("fts", [None, (8, 16)])
def test_port_saved_npz_loads_in_jax(tmp_path, fts):
    """A port ``state_dict`` saved with ``save_params`` loads into the
    JAX ``ClassposeModel``, config included, and both forwards agree at
    fp32 to 1e-5."""
    cfg = ClassTransformerConfig(**{**TINY, "rdrop": 0.25,
                                    "feature_transformation_structure": fts})
    torch.manual_seed(3)
    net = ClassTransformer(cfg)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    path = str(tmp_path / "port.npz")
    save_params(net.state_dict(), path, cfg)
    jm = JaxModel(pretrained_model=path, precision="fp32")
    assert jm.cfg.rdrop == 0.25 and jm.cfg.n_cell_classes == 4
    assert jm.cfg.feature_transformation_structure == fts
    x = np.random.default_rng(5).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    ref, _ = jm.net.apply(jm.params, jnp.asarray(x))
    net2 = ClassTransformer(cfg)
    load_into(net2, params_from_jax(jm.params))
    with torch.no_grad():
        got, _ = net(torch.from_numpy(x))
        got2, _ = net2(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
