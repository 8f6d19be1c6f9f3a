"""CLI options that no other port test runs, each held against the JAX
CLI on the same inputs on the CPU at a tiny size.

- ``classpose-train``: ``train_class_seg`` is intercepted in both
  packages, and what each CLI hands it is compared: the
  ``--subsample_fraction`` choice and the ``--make_sparse`` labels (both
  from ``np.random.default_rng(seed)``), the sampling probabilities under
  ``--oversampling_method none|custom`` and ``--oversampling_power 2``,
  the class weights under ``--no_class_weights``,
  ``--no_uncertainty_weighting``, the freeze selection and the parameters
  it leaves trainable under ``--freeze backbone neck`` and ``--freeze
  seg``, the learning rate under ``--lr_scaling sqrt`` at world 1, and
  ``--n_rare_classes`` accepted and ignored. Then ``--save_every 1
  --save_each`` trains for real and both write the same files.
- ``classpose-evaluate``: ``--cellprob_threshold 0.5 --max_images 1
  --background_class``; masks compared as masks, the same PQ table.
- ``classpose-calculate-metrics``: ``--ignore_classes`` and
  ``--match_iou 0.3``; the same PQ rows.
- ``classpose-predict-wsi``: ``--filter_background_tiles`` on an array
  slide with blank tiles; the same tiles kept, the same cells
  (``tests/test_torch_pipeline.py``'s rule)."""

import csv
import functools
import hashlib
import json
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params as jax_save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu_torch.nn.convert import params_from_jax

from test_torch_data import assert_targets_match, disc_sample
from test_torch_eval import _same_masks
from test_torch_metrics import KEYS, _pairs
from golden.jax_native import jax_native_geometry  # noqa: F401

# ------------------------------------------------------------ classpose-train

TRAIN_RUNS = {
    # name → extra flags
    "a": ["--subsample_fraction", "0.75", "--make_sparse",
          "--oversampling_power", "2", "--no_uncertainty_weighting",
          "--freeze", "backbone", "neck", "--lr_scaling", "sqrt",
          "--n_rare_classes", "2"],
    "b": ["--oversampling_method", "none", "--no_class_weights",
          "--freeze", "seg", "--n_rare_classes", "7"],
    "b_default_rare": ["--oversampling_method", "none", "--no_class_weights",
                       "--freeze", "seg"],
}


def _train_data(d, n=8):
    data, labels = zip(*[disc_sample(i, n_classes=4) for i in range(n)])
    d.mkdir()
    np.save(d / "images.npy", np.stack(data))
    np.save(d / "labels.npy", np.stack(labels))
    return d


def _train_argv(data, out, extra):
    """The base flags, then ``extra`` (a flag given again there wins:
    argparse keeps the last)."""
    return ["--data_path", str(data), "--output_dir", str(out),
            "--model_name", "m", "--tiny_model", "--bsize", "64",
            "--min_train_masks", "1", "--train_fraction", "0.75",
            "--epochs", "2", "--batch_size", "2", "--seed", "3"] + extra


@pytest.fixture(scope="module")
def train_calls(tmp_path_factory):
    """name → (JAX call, port call); a call is (model, train dataset,
    keyword arguments) as handed to ``train_class_seg``."""
    import classpose_tpu.train.train as jax_train
    import classpose_tpu_torch.train.train as port_train
    from classpose_tpu.entrypoints.run_training import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.run_training import main_with_args

    tmp = tmp_path_factory.mktemp("train_opts")
    data = _train_data(tmp / "data")
    calls = {}
    mp = pytest.MonkeyPatch()

    def recorder(store):
        def fake(model, train_dataset, **kw):
            store.append((model, train_dataset, kw))
            return "", None, None
        return fake

    try:
        jax_init_jitted(mp)
        for name, extra in TRAIN_RUNS.items():
            got = []
            mp.setattr(jax_train, "train_class_seg", recorder(got))
            mp.setattr(port_train, "train_class_seg", recorder(got))
            jax_main(_train_argv(data, tmp / "jax", extra))
            main_with_args(_train_argv(data, tmp / "port", extra)
                           + ["--device", "cpu"])
            calls[name] = tuple(got)
    finally:
        mp.undo()
    return calls


def test_subsample_and_sparse_labels_match(train_calls):
    """The same images chosen and the same instances keep their class:
    images and the instance, class and binary label channels bitwise; the
    flow channels as ``tests/test_torch_data.py`` holds them."""
    (_, jds, _), (_, pds, _) = train_calls["a"]
    (_, full, _), _ = train_calls["b"]
    assert len(pds) == len(jds) == 4 < len(full)
    np.testing.assert_array_equal(pds.data_array, jds.data_array)
    lp, lj = np.asarray(pds.label_array), np.asarray(jds.label_array)
    for got, ref in zip(lp, lj):
        assert_targets_match(got, ref)
    # --make_sparse (which, given [instance, class] maps, clears the
    # instance channel of the dropped cells in both packages) left fewer
    # cells an image than the full set holds
    def cells(ds):
        return np.mean([len(np.unique(lab[0])) - 1
                        for lab in np.asarray(ds.label_array)])
    assert cells(jds) < cells(full) - 1


@pytest.mark.parametrize("run", ["a", "b"])
def test_probabilities_and_class_weights_match(train_calls, run):
    (_, _, jkw), (_, _, pkw) = train_calls[run]
    for key in ("train_probs", "class_weights"):
        if run == "b":  # --oversampling_method none, --no_class_weights
            assert jkw[key] is None and pkw[key] is None
        else:
            np.testing.assert_array_equal(np.asarray(pkw[key]),
                                          np.asarray(jkw[key]))
    if run == "a":  # --oversampling_power 2 changes the probabilities
        from classpose_tpu_torch.train.train_utils import (
            compute_oversampling_probabilities,
        )

        _, ds, _ = train_calls["a"][1]
        p1 = compute_oversampling_probabilities(
            ds.class_counts, ds.instance_counts, power=1)
        assert not np.allclose(p1, pkw["train_probs"])


@pytest.mark.parametrize("run", ["a", "b"])
def test_scalar_options_match(train_calls, run):
    """Uncertainty weighting, learning rate (``--lr_scaling sqrt`` leaves
    it at world 1), freeze dict, seg head, epochs and checkpoint cadence."""
    (_, _, jkw), (_, _, pkw) = train_calls[run]
    for key in ("use_uncertainty_weighting", "learning_rate", "freeze",
                "seg_trainable", "n_epochs", "batch_size", "save_every",
                "save_each", "random_seed"):
        assert pkw[key] == jkw[key], key
    assert pkw["use_uncertainty_weighting"] is (run == "b")
    assert pkw["learning_rate"] == 5e-5
    assert pkw["seg_trainable"] is (run == "a")


@pytest.mark.parametrize("run", ["a", "b"])
def test_freeze_selection_matches(train_calls, run):
    """The parameters each trainer leaves trainable under the CLI's
    freeze selection, mapped to the port's names."""
    from classpose_tpu.train.train import _freeze_label_tree
    from classpose_tpu_torch.train.train import freeze_labels

    (jmodel, _, jkw), (pmodel, _, pkw) = train_calls[run]
    f = jkw["freeze"]
    labels = _freeze_label_tree(
        jmodel.params, freeze_backbone=f.get("backbone", False),
        freeze_instance_classification=f.get("instance_classification",
                                             False),
        freeze_neck=f.get("neck", False))
    marks = params_from_jax(jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), lab == "net", np.float32),
        labels, jmodel.params))
    ref = {k for k, v in marks.items() if bool(v.all())}
    assert all(bool(v.all()) or not bool(v.any()) for v in marks.values())
    got = {k for k, v in freeze_labels(pmodel.net, pkw["freeze"]).items()
           if v == "net"}
    assert got == ref and got
    frozen = set(marks) - ref
    if run == "a":
        assert any(k.startswith("encoder.neck") for k in frozen)
        assert any(k.startswith("encoder.blocks") for k in frozen)
    else:
        assert frozen == {"out.weight", "out.bias"}


def test_n_rare_classes_is_ignored(train_calls):
    """``--n_rare_classes 7`` hands ``train_class_seg`` what its default
    does, in each package."""
    for i in range(2):
        _, ds, kw = train_calls["b"][i]
        _, ds0, kw0 = train_calls["b_default_rare"][i]
        kw = {k: v for k, v in kw.items() if k != "config_snapshot"}
        kw0 = {k: v for k, v in kw0.items() if k != "config_snapshot"}
        assert kw.keys() == kw0.keys()
        for k in kw:
            if k in ("test_dataset",):
                continue
            assert np.array_equal(np.asarray(kw[k], object),
                                  np.asarray(kw0[k], object)), k
        np.testing.assert_array_equal(ds.data_array, ds0.data_array)


def test_save_each_writes_jax_files(tmp_path, monkeypatch):
    """``--save_every 2 --save_each`` for 3 epochs: both packages write
    the final ``.npz``, ``checkpoint_last.train`` and the checkpoints of
    epochs 0 and 2, under the same names. What is held is which
    checkpoints the trainers write, so the JAX trainer's step returns its
    state and its checkpoint writer makes the directory it is given
    (compiling the real step on the test's 8-device CPU mesh and orbax's
    writes take ~25 s); the port trains and writes for real."""
    from classpose_tpu.entrypoints.run_training import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.run_training import main_with_args

    jax_init_jitted(monkeypatch)
    jax_trainer_writes_names_only(monkeypatch)
    data = _train_data(tmp_path / "data")
    extra = ["--save_every", "2", "--save_each", "--train_fraction", "1.0",
             "--batch_size", "8", "--oversampling_method", "none",
             "--epochs", "3"]
    jax_main(_train_argv(data, tmp_path / "jax", extra))
    main_with_args(_train_argv(data, tmp_path / "port", extra)
                   + ["--device", "cpu"])
    names = {k: sorted(os.listdir(tmp_path / k / "m"))
             for k in ("jax", "port")}
    assert names["port"] == names["jax"] == [
        "checkpoint_epoch_0.train", "checkpoint_epoch_2.train",
        "checkpoint_last.train", "m.npz"]


@functools.partial(jax.jit, static_argnums=0)
def _jax_init(net, key, x):
    return flax.linen.Module.init(net, key, x)


def jax_init_jitted(monkeypatch):
    """Run the JAX ``ClassTransformer.init`` that ``ClassposeModel`` calls
    without weights as one compiled program, cached by config, instead of
    op by op (~8 s for the tiny net on the CPU, each time in a fresh
    process): the same initialisers, values within float32 rounding."""
    from classpose_tpu.nn.vit_sam import ClassTransformer

    monkeypatch.setattr(ClassTransformer, "init",
                        lambda self, key, x: _jax_init(self, key, x))


def jax_trainer_writes_names_only(monkeypatch):
    """Make the JAX ``train_class_seg`` run its loop and its checkpoint
    cadence without its compiled step or orbax's writes: the step returns
    its state with zero losses, the writer makes the directory."""
    import jax.numpy as jnp

    import classpose_tpu.train.train as jax_train

    def still_step(*args, **kwargs):
        zero = {k: jnp.float32(0) for k in ("seg", "ce", "tversky", "total")}
        return lambda params, lv, opt, key, X, lbl: (params, lv, opt, key,
                                                     zero)

    monkeypatch.setattr(jax_train, "make_train_step", still_step)
    monkeypatch.setattr(jax_train, "_save_checkpoint",
                        lambda path, *args, **kwargs: os.makedirs(
                            path, exist_ok=True))


# --------------------------------------------------------- classpose-evaluate

EVAL_CFG = dict(n_cell_classes=4, ps=4, embed_dim=64, depth=2, num_heads=4,
                neck_dim=64, bsize=64)


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    """A tiny fp32 checkpoint and 2 images of 128² with labels made from
    the JAX model's own masks (every third cell dropped)."""
    from classpose_tpu.runner import ClassposeModel as JaxModel

    d = tmp_path_factory.mktemp("evalopts")
    cfg = JaxCfg(**EVAL_CFG)
    jax_save_params(perturbed_structured_params(cfg, ripple=0.5, seed=1),
                    str(d / "m.npz"), cfg=cfg)
    images = np.random.default_rng(6).uniform(
        0, 255, size=(2, 128, 128, 3)).astype(np.float32)
    model = JaxModel(pretrained_model=str(d / "m.npz"), precision="fp32")
    labels = []
    for img in images:
        m, _, c, _ = model.eval(img)
        m = np.where(m % 3 == 0, 0, m)
        labels.append(np.stack([m, np.where(m > 0, c, 0)]))
    np.save(d / "images.npy", images)
    np.save(d / "labels.npy", np.stack(labels).astype(np.int32))
    return d


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _rows_equal(got, ref):
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        assert g.keys() == r.keys()
        for k in r:
            if k in KEYS:
                assert float(g[k]) == pytest.approx(float(r[k]), abs=1e-6), k
            else:
                assert g[k] == r[k], k


@pytest.mark.parametrize("threshold", ["0.5", "5.3"])
def test_evaluate_options_match_jax(eval_set, tmp_path, threshold):
    """``--cellprob_threshold T --max_images 1 --background_class``: one
    image, masks as masks with each instance's class, the same PQ table
    over the classes but the background. The checkpoint's cellprob is
    ±5–7, so 0.5 segments as the default 0.0 does and 5.3 drops part of
    the foreground."""
    from classpose_tpu.entrypoints.run_inference import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.run_inference import main_with_args

    argv = ["--data_path", str(eval_set), "--model_path",
            str(eval_set / "m.npz"), "--cellprob_threshold", threshold,
            "--max_images", "1", "--background_class"]
    jax_main(argv + ["--output_dir", str(tmp_path / "jax")])
    res = main_with_args(argv + ["--output_dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    ref = np.load(tmp_path / "jax" / "predictions.npy")
    got = np.load(tmp_path / "port" / "predictions.npy")
    assert got.shape == ref.shape == (1, 128, 128, 2)
    pairs = _same_masks(got[0, ..., 0], ref[0, ..., 0])
    for a, b, _ in pairs:
        assert ref[0, ..., 1][ref[0, ..., 0] == a][0] == \
            got[0, ..., 1][got[0, ..., 0] == b][0]
    for name in ("metrics.csv", "metrics_per_image.csv"):
        _rows_equal(_rows(tmp_path / "port" / name),
                    _rows(tmp_path / "jax" / name))
    # 4 model classes, the background excluded: 3 class rows and the
    # summary rows
    assert res["n_images"] == 1
    default = main_with_args(argv[:4] + ["--max_images", "1", "--output_dir",
                                         str(tmp_path / "d"), "--device",
                                         "cpu"])
    assert len(default["metrics"]) == len(res["metrics"]) + 1
    fg = (np.load(tmp_path / "d" / "predictions.npy")[..., 0] > 0).sum()
    assert bool(fg > (got[..., 0] > 0).sum()) is (threshold == "5.3")


# ----------------------------------------------- classpose-calculate-metrics

@pytest.mark.parametrize("extra", [
    ["--ignore_classes", "1", "3"],
    ["--match_iou", "0.3"],
    ["--ignore_classes", "2", "--match_iou", "0.3", "--binary"],
], ids=["ignore", "match_iou", "binary"])
def test_calculate_metrics_options_match_jax(tmp_path, extra):
    from classpose_tpu.entrypoints.calculate_metrics import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.calculate_metrics import (
        main_with_args,
    )

    gts, preds = _pairs(n_images=3, seed=4)
    if "--binary" in extra:
        gts, preds = [g[..., 0] for g in gts], [p[..., 0] for p in preds]
    np.save(tmp_path / "gt.npy", np.stack(gts))
    np.save(tmp_path / "pred.npy", np.stack(preds))
    argv = ["--gt_path", str(tmp_path / "gt.npy"), "--pred_path",
            str(tmp_path / "pred.npy")] + extra
    jax_main(argv + ["--output", str(tmp_path / "jax.csv")])
    got = main_with_args(argv + ["--output", str(tmp_path / "port.csv")])
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv")
    if "--binary" not in extra:
        assert _rows(tmp_path / "port_per_image.csv") == \
            _rows(tmp_path / "jax_per_image.csv")
    base = main_with_args(argv[:4] + (["--binary"] if "--binary" in extra
                                      else []))
    assert [r["pq"] for r in got] != [r["pq"] for r in base]


# --------------------------------------------------- classpose-predict-wsi

WSI_CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
               neck_dim=64, bsize=64)


def _wsi_args(tmp, out, device):
    return type("Args", (), dict(
        model_config=str(tmp / "config.yaml"),
        slide_path=str(tmp / "slide.npy"), output_folder=str(out),
        tile_size=256, overlap=64, batch_size=8, precision="fp32",
        tta=False, roi_geojson=None, output_type=["csv"],
        tissue_detection_model_path=None,
        artefact_detection_model_path=None, filter_artefacts=False,
        roi_class_priority=None, min_area=0, mpp=0.4, device=device,
        inference_threads=2, filter_background_tiles=True,
    ))()


def _centroids(path):
    with open(path) as f:
        feats = json.load(f)["features"]
    return (np.array([f["geometry"]["coordinates"] for f in feats]),
            [f["properties"]["classification"]["name"] for f in feats])


def test_filter_background_tiles_matches_jax(tmp_path, monkeypatch):
    """A 900 × 700 slide whose right third and bottom rows are blank:
    both pipelines drop the same tiles (the filter's verdict on each tile,
    keyed by its pixels) and find the same cells."""
    import classpose_tpu.pipeline.tile_filter as jax_filter
    import classpose_tpu_torch.pipeline.predict_wsi as port_pipeline
    from classpose_tpu.io.array_reader import synthetic_wsi
    from classpose_tpu.pipeline.predict_wsi import main as jax_main

    slide, _ = synthetic_wsi(width=900, height=700, n_cells=60, seed=7,
                             mpp=0.4)
    img = np.array(slide._level0)
    img[:, 600:] = 255
    img[450:] = 255
    np.save(tmp_path / "slide.npy", img)
    cfg = JaxCfg(**WSI_CFG)
    jax_save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                    str(tmp_path / "ckpt.npz"), cfg=cfg)
    (tmp_path / "config.yaml").write_text(
        f"path: {tmp_path}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in "ABCDEF"))
    monkeypatch.setenv("WSI_READER", "array")
    verdicts = {"jax": [], "port": []}

    def recording(fn, store):
        def wrapped(tile):
            keep = bool(fn(tile))
            store.append((hashlib.sha256(np.ascontiguousarray(
                tile).tobytes()).hexdigest(), keep))
            return keep
        return wrapped

    monkeypatch.setattr(jax_filter, "filter_tile",
                        recording(jax_filter.filter_tile, verdicts["jax"]))
    monkeypatch.setattr(port_pipeline, "filter_tile",
                        recording(port_pipeline.filter_tile,
                                  verdicts["port"]))
    ref = jax_main(_wsi_args(tmp_path, tmp_path / "jax", None))
    got = port_pipeline.main(_wsi_args(tmp_path, tmp_path / "port", "cpu"))
    assert sorted(verdicts["port"]) == sorted(verdicts["jax"])
    kept = sum(k for _, k in verdicts["port"])
    assert 0 < kept < len(verdicts["port"])
    assert got["n_tiles"] == ref["n_tiles"] == kept
    p, pn = _centroids(tmp_path / "port" / "slide_cell_centroids.geojson")
    r, rn = _centroids(tmp_path / "jax" / "slide_cell_centroids.geojson")
    assert len(r) > 10 and abs(len(p) - len(r)) <= max(1, len(r) // 200)
    dist, idx = cKDTree(r).query(p)
    same = (dist <= 1.0) & (np.array(pn) == np.array(rn)[idx])
    assert same.mean() >= 0.99
