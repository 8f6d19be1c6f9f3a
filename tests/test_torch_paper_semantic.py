"""The semantic Cellpose-SAM baseline: the port's
``classpose_tpu_torch.paper_experiments.run_cellpose_semantic`` against
the JAX script ``paper_experiments/run_cellpose_semantic.py`` on the CPU.

- the rescale: ``rescale_ratio`` on a table of specs; ``cvlite``'s
  ``INTER_LINEAR`` (uint8, uint16, float32) and ``INTER_NEAREST`` (int32
  label stacks) bitwise against cv2 over seeded shapes: up, down, the
  exact 2× downsample and non-integer ratios, and IPP's outer-column runs;
- the graft: the class head bitwise equal to the JAX graft after
  ``params_from_jax``, with no weights, a published ``.pt`` of another
  class count and an ``.npz`` with metadata; the refusals;
- one train step of the grafted model against the JAX step, with
  ``tests/test_torch_train.py``'s harness and tolerances;
- ``main --skip_training`` on an ``.npz`` the JAX package saved, rescaling
  both ways: the same object array, masks compared as masks
  (``tests/test_torch_eval.py``'s rule) and classes per instance;
- a tiny ``main --epochs 1`` writing the JAX script's file names."""

import importlib.util
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params as jax_save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.train.train import _make_optimizer as jax_optimizer
from classpose_tpu.train.train import make_train_step as jax_train_step
from classpose_tpu_torch.nn import ClassTransformer, ClassTransformerConfig
from classpose_tpu_torch.nn.convert import params_from_jax, save_params
from classpose_tpu_torch.paper_experiments import run_cellpose_semantic as P
from classpose_tpu_torch.train.train import make_optimizer, make_train_step
from classpose_tpu_torch.transforms import cvlite

from test_torch_checkpoints import replica
from test_torch_cli_options import (
    jax_init_jitted,
    jax_trainer_writes_names_only,
)
from test_torch_data import disc_sample
from test_torch_eval import _same_masks
from test_torch_train import _batch
from golden.jax_native import jax_native_geometry  # noqa: F401

_spec = importlib.util.spec_from_file_location(
    "jax_run_cellpose_semantic", Path(__file__).resolve().parents[1]
    / "paper_experiments" / "run_cellpose_semantic.py")
J = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(J)

TINY = dict(embed_dim=32, depth=1, num_heads=2, neck_dim=16, bsize=64)


# ------------------------------------------------------------- rescale

@pytest.mark.parametrize("spec", ["", "0.25:0.5", "0.5:0.25", "0.5:0.5",
                                  "0.3:0.45", "2", "0.75", "1"])
def test_rescale_ratio_matches_jax(spec):
    assert P.rescale_ratio(spec) == J.rescale_ratio(spec)


def _image(rng, dtype, shape):
    if dtype == np.float32:
        return rng.normal(0, 100, shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


# (source H, W) → (target H, W); the last two make IPP run its own code on
# the outer columns (runs of 16, rests of 5 or more)
SHAPES = {
    "up": ((37, 41), (80, 95)),
    "down": ((90, 77), (31, 50)),
    "half": ((96, 130), (48, 65)),
    "half_odd": ((14, 6), (7, 3)),
    "non_integer": ((64, 64), (80, 80)),
    "one_axis": ((40, 33), (40, 70)),
    "thin": ((1, 30), (5, 61)),
    "outer_runs": ((26, 3), (8, 83)),
    "outer_long": ((9, 2), (30, 101)),
}


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("case", list(SHAPES))
def test_resize_linear_bitwise_cv2(case, dtype, channels):
    (sh, sw), (dh, dw) = SHAPES[case]
    rng = np.random.default_rng(len(case) * 7 + channels)
    img = _image(rng, dtype, (sh, sw) if channels == 0
                 else (sh, sw, channels))
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    got = cvlite.resize_linear(img, dw, dh)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_resize_linear_seeded_sweep():
    """300 seeded shapes and ratios (a third of them exact 2×
    downsamples) in each dtype, 3 channels, bitwise."""
    rng = np.random.default_rng(11)
    for i in range(300):
        dtype = (np.uint8, np.uint16, np.float32)[i % 3]
        sh, sw = (int(v) for v in rng.integers(2, 120, 2))
        if i % 9 < 3:
            sh, sw = 2 * max(sh // 2, 1), 2 * max(sw // 2, 1)
            dh, dw = sh // 2, sw // 2
        else:
            dh, dw = (int(v) for v in rng.integers(1, 160, 2))
        img = _image(rng, dtype, (sh, sw, 3))
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = cvlite.resize_linear(img, dw, dh)
        assert got.shape == ref.shape and np.array_equal(
            got.view(np.uint8), ref.view(np.uint8)), (dtype, sh, sw, dh, dw)


@pytest.mark.parametrize("shape,target", [
    ((96, 96), (48, 48)), ((48, 40), (96, 80)), ((57, 43), (100, 31)),
    ((20, 20), (20, 21)), ((7, 300), (13, 301))])
def test_resize_nearest_bitwise_cv2(shape, target):
    rng = np.random.default_rng(shape[0])
    lbl = rng.integers(-3, 1 << 20, shape + (2,)).astype(np.int32)
    ref = cv2.resize(lbl, target[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(
        cvlite.resize_nearest(lbl, target[1], target[0]), ref)


@pytest.mark.parametrize("dtype", [np.int32, np.float64, np.int8, bool])
def test_resize_linear_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match=np.dtype(dtype).name):
        cvlite.resize_linear(np.zeros((8, 8, 3), dtype), 4, 4)


@pytest.mark.parametrize("spec", ["0.25:0.5", "0.5:0.25", "0.4:0.5",
                                  "0.5:0.5"])
def test_rescale_functions_match_jax(spec):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 70, 3)).astype(np.uint8)
    got = P.rescale_if_necessary(img, spec)
    ref = J.rescale_if_necessary(img, spec)
    np.testing.assert_array_equal(got, ref)
    lab = rng.integers(0, 40, got.shape[:2] + (2,))
    np.testing.assert_array_equal(
        P.rescale_label_if_necessary(lab, img.shape[:2]),
        J.rescale_label_if_necessary(lab, img.shape[:2]))


# --------------------------------------------------------------- graft

@pytest.fixture(scope="module")
def donors(tmp_path_factory):
    """A published ``.pt`` with a 1×1 head of 6 classes, a cpsam ``.pt``
    (no class head) and ``.npz`` files with metadata: 1×1 heads of 4 and
    5 classes, a UNet head of 4; all at the script's tiny size."""
    d = tmp_path_factory.mktemp("donors")
    for name, n in (("conv6", 6), ("cpsam", 1)):
        net = replica(n, None, seed=n, ps=8, bsize=64, depth=1)
        torch.save(net.state_dict(), d / f"{name}.pt")
    for name, n, head in (("k4", 4, None), ("k5", 5, None),
                          ("unet4", 4, (8,))):
        # every tensor seeded noise, as tests/test_torch_nn.py draws it
        cfg = ClassTransformerConfig(
            n_cell_classes=n, feature_transformation_structure=head, **TINY)
        rng = np.random.default_rng(n)
        sd = {k: torch.from_numpy((rng.normal(size=v.shape) * (
            0.5 if "rel_pos" in k else 0.05)).astype(np.float32))
            for k, v in ClassTransformer(cfg).state_dict().items()}
        save_params(sd, str(d / f"{name}.npz"), cfg)
    return d


def _jax_sd(model):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, model.params))


@pytest.mark.parametrize("donor", [None, "conv6.pt", "k4.npz", "unet4.npz"])
def test_graft_matches_jax(donors, donor, monkeypatch):
    """The class head is the JAX graft bit for bit. With weights, every
    tensor equals the JAX model's; with none, each package's own init
    differs, so the port's graft applied to the JAX ``out`` head must give
    the JAX ``out_class`` (the channel order through ``params_from_jax``).
    A UNet class head stays as loaded in both: the JAX graft adds a 1×1
    kernel and bias beside its blocks, which the UNet never reads."""
    path = None if donor is None else str(donors / donor)
    jax_init_jitted(monkeypatch)
    ref = _jax_sd(J.build_semantic_model(4, path, tiny=True))
    model = P.build_semantic_model(4, path, tiny=True, device="cpu")
    got = model.net.state_dict()
    if donor == "unet4.npz":
        assert ref.pop("out_class.weight").shape == (4 * 64, 16, 1, 1)
        ref.pop("out_class.bias")
        assert got.keys() == ref.keys()
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
        return
    assert model.nclasses == 4 and got.keys() == ref.keys()
    assert got["out_class.weight"].shape == (4 * 64, 16, 1, 1)
    ps = model.cfg.ps
    for sd in (ref, got):
        w, b = P.semantic_head(sd["out.weight"], sd["out.bias"], 4, ps)
        assert torch.equal(sd["out_class.weight"], w)
        assert torch.equal(sd["out_class.bias"], b)
    if donor is not None:
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    else:
        assert not torch.equal(got["out.weight"], ref["out.weight"])


def test_graft_refusals(donors):
    """A cpsam ``.pt`` has no class head: the JAX script raises its
    ``KeyError`` and the port a ``KeyError`` naming the head. An ``.npz``
    of 5 classes given labels of 4: the JAX graft writes a head its net
    cannot hold (its first forward fails); the port refuses at once."""
    with pytest.raises(KeyError):
        J.build_semantic_model(4, str(donors / "cpsam.pt"), tiny=True)
    with pytest.raises(KeyError, match="out_class"):
        P.build_semantic_model(4, str(donors / "cpsam.pt"), tiny=True,
                               device="cpu")
    jm = J.build_semantic_model(4, str(donors / "k5.npz"), tiny=True)
    with pytest.raises(Exception, match="out_class"):  # while tracing
        jax.jit(jm.net.apply)(jm.params, jnp.zeros((1, 3, 64, 64)))
    with pytest.raises(ValueError, match="5 classes"):
        P.build_semantic_model(4, str(donors / "k5.npz"), tiny=True,
                               device="cpu")


def test_one_train_step_matches_jax(donors):
    """One AdamW step of the grafted model, the script's weight decay 0.1,
    class weights and no uncertainty weighting, from the same weights on
    the same batch: ``tests/test_torch_train.py``'s tolerances (losses
    rtol 1e-5; parameters rtol 1e-4 / atol 5e-6, ≥ 99.99% of elements
    within atol 1e-6), at its constant learning rate of 1e-3.

    The cross-entropy is held to its float64 value instead, the port to
    rtol 1e-6: the graft gives every nucleus class the same logit, so the
    CE is a sum of ~7400 terms near log 4, and XLA's float32 sum on the
    CPU lands 1.1e-5 (relative) below the float64 value on this batch,
    the port 5e-8 from it. The JAX value is held to 2e-5."""
    jm = J.build_semantic_model(4, str(donors / "k4.npz"), tiny=True)
    tm = P.build_semantic_model(4, str(donors / "k4.npz"), tiny=True,
                                device="cpu")
    rng = np.random.default_rng(7)
    X = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    _, lbl = _batch(seed=8)
    cw = np.array([0.7071, 1.0, 1.2247, 0.8165], np.float32)
    lr = np.full(2, 1e-3)

    params = jm.params
    y = np.asarray(jax.jit(jm.net.apply)(params, jnp.asarray(X))[0],
                   np.float64)
    tx = jax_optimizer(lr, 0.1, params, None, False)
    log_var = jnp.zeros(3, jnp.float32)
    state = [params, log_var, tx.init((params, log_var)),
             jax.random.PRNGKey(0)]
    step = jax_train_step(jm.net, tx, 4, class_weights=cw, rdrop=False)
    *state, ref_m = step(*state, jnp.asarray(X), jnp.asarray(lbl))

    tlv = torch.zeros(3)
    opt = make_optimizer(tm.net, tlv, 0.1, None, False)
    tstep = make_train_step(tm.net, opt, tlv, lr, 4, class_weights=cw,
                            rdrop=False)
    tm.net.train()
    got_m = tstep(torch.from_numpy(X), torch.from_numpy(lbl))
    for k, v in ref_m.items():
        if k != "ce":
            np.testing.assert_allclose(float(got_m[k]), float(v), rtol=1e-5,
                                       err_msg=k)
    logits, target = y[:, :4], lbl[:, 0].astype(np.int64)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    picked = np.take_along_axis(logp, np.maximum(target, 0)[:, None], 1)
    w = cw.astype(np.float64)[np.maximum(target, 0)] * (target != -100)
    ce = -(picked[:, 0] * w).sum() / w.sum()
    np.testing.assert_allclose(float(got_m["ce"]), ce, rtol=1e-6)
    np.testing.assert_allclose(float(ref_m["ce"]), ce, rtol=2e-5)
    ref_sd = params_from_jax(state[0])
    close = total = 0
    for k, p in tm.net.state_dict().items():
        got, ref = p.numpy(), ref_sd[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-6,
                                   err_msg=k)
        close += int(np.isclose(got, ref, rtol=1e-4, atol=1e-6).sum())
        total += got.size
    assert close >= 0.9999 * total


# ---------------------------------------------------------- end to end

CELL_CFG = dict(n_cell_classes=3, ps=4, embed_dim=64, depth=2, num_heads=4,
                neck_dim=64, bsize=64)


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["run_cellpose_semantic.py"] + argv)
    J.main()


def _write_training_set(d, n):
    """n disc images with labels of classes 1–3 (the tiny net of 4 classes
    that the graft tests and the training CLI's tests build)."""
    data, labels = zip(*[disc_sample(i, n_classes=4) for i in range(n)])
    np.save(d / "train_x.npy",
            np.stack([x.transpose(1, 2, 0) for x in data]).astype(np.uint8))
    np.save(d / "train_y.npy",
            np.stack([y.transpose(1, 2, 0) for y in labels]).astype(
                np.int32))


@pytest.mark.parametrize("spec,shapes", [
    ("0.25:0.5", [(128, 128), (128, 128)]),   # 2× down, equal shapes
    ("0.5:0.25", [(32, 32), (24, 32)]),       # 2× up, unequal heights
])
def test_skip_training_matches_jax(tmp_path, monkeypatch, spec, shapes):
    """``--skip_training`` on the ``.npz`` the JAX package saved (weights
    that give cells): the same object array, each map equal as masks with
    each instance's class."""
    _write_training_set(tmp_path, n=2)
    cfg = JaxCfg(**CELL_CFG)
    (tmp_path / "models" / "cellpose_t").mkdir(parents=True)
    jax_save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                    str(tmp_path / "models" / "cellpose_t" /
                        "cellpose_t.npz"), cfg=cfg)
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(0, 255, s + (3,)).astype(np.uint8) for s in shapes]
    test = np.empty(len(imgs), object)
    test[:] = imgs
    np.save(tmp_path / "test_x.npy",
            np.stack(imgs) if len(set(shapes)) == 1 else test)
    argv = ["--train_data_path", str(tmp_path / "train_x.npy"),
            "--train_labels_path", str(tmp_path / "train_y.npy"),
            "--test_data_path", str(tmp_path / "test_x.npy"),
            "--dataset_name", "t", "--save_path", str(tmp_path / "models"),
            "--training_to_inference_mpp", spec, "--skip_training"]
    _run_jax(monkeypatch, argv + ["--out_path", str(tmp_path / "j.npy")])
    stats = P.main(argv + ["--out_path", str(tmp_path / "p.npy"),
                           "--device", "cpu"])
    assert stats["eval_images"] == 2 and stats["train_images"] == 0
    ref = np.load(tmp_path / "j.npy", allow_pickle=True)
    got = np.load(tmp_path / "p.npy", allow_pickle=True)
    assert got.dtype == ref.dtype == object and got.shape == ref.shape
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        g, r = g.astype(np.int32), r.astype(np.int32)
        pairs = _same_masks(g[..., 0], r[..., 0])
        for a, b, _ in pairs:
            assert r[..., 1][r[..., 0] == a][0] == g[..., 1][g[..., 0] == b][0]
        assert (g[..., 1][g[..., 0] == 0] == 0).all()


def test_tiny_training_writes_jax_file_names(tmp_path, monkeypatch):
    """``--tiny_model --epochs 1`` on 8 images of 96²: both write the
    final ``.npz``, ``checkpoint_last.train/`` and the predictions, an
    object array of one (96, 96, 2) map per test image. The JAX trainer
    runs its loop without its compiled step or orbax's writes
    (``tests/test_torch_cli_options.py``); the one-step parity is
    ``test_one_train_step_matches_jax``'s."""
    jax_init_jitted(monkeypatch)
    jax_trainer_writes_names_only(monkeypatch)
    _write_training_set(tmp_path, n=8)
    np.save(tmp_path / "test_x.npy",
            np.load(tmp_path / "train_x.npy")[:2])
    outs = {}
    for name in ("jax", "port"):
        argv = ["--train_data_path", str(tmp_path / "train_x.npy"),
                "--train_labels_path", str(tmp_path / "train_y.npy"),
                "--test_data_path", str(tmp_path / "test_x.npy"),
                "--dataset_name", "t", "--tiny_model", "--epochs", "1",
                "--training_to_inference_mpp", "0.25:0.5",
                "--save_path", str(tmp_path / name / "models"),
                "--out_path", str(tmp_path / name / "out" / "preds.npy")]
        if name == "jax":
            _run_jax(monkeypatch, argv)
        else:
            stats = P.main(argv + ["--device", "cpu"])
            assert stats["train_images"] == 8 and stats["train_s"] > 0
        root = tmp_path / name
        outs[name] = sorted(str(p.relative_to(root))
                            for p in root.glob("*/*/*"))
        preds = np.load(root / "out" / "preds.npy", allow_pickle=True)
        assert preds.dtype == object and preds.shape == (2, 96, 96, 2)
    assert outs["port"] == outs["jax"]
    assert "models/cellpose_t/cellpose_t.npz" in outs["port"]
    assert "models/cellpose_t/checkpoint_last.train" in outs["port"]


def test_parser_matches_jax_flags():
    """Every flag of the JAX script with its default and type, plus
    ``--device`` (``auto``)."""
    import argparse

    captured = {}

    class Stop(Exception):
        pass

    def parse(self, args=None, namespace=None):
        captured["p"] = self
        raise Stop

    old = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse
    try:
        with pytest.raises(Stop):
            J.main()
    finally:
        argparse.ArgumentParser.parse_args = old

    def opts(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.nargs,
                         type(a)) for a in p._actions if a.option_strings}

    ref, got = opts(captured["p"]), opts(P.build_parser())
    assert got.pop("device")[1] == "auto"
    assert got == ref
