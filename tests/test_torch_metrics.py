"""The port's metrics (no pandas, no sklearn) against the JAX package's,
and both evaluation CLIs end to end against the JAX CLIs.

PQ, DQ, SQ and the counts agree to 1e-6 (they are the same float64
arithmetic on the same integer contingency tables); the R² is sklearn's
``r2_score`` to 1e-12. The CLIs: ``classpose-evaluate`` on 2 images of
128² with a tiny fp32 checkpoint, predictions compared as masks and PQ
rows to 1e-6; ``classpose-calculate-metrics`` on the same files."""

import csv
import subprocess
import sys

import numpy as np
import pytest

from classpose_tpu.metrics.pq import (
    compute_binary_pq_metrics as jax_binary,
    compute_multiclass_pq_metrics as jax_multiclass,
)
from classpose_tpu.metrics.stats_utils import get_multi_r2 as jax_r2
from classpose_tpu_torch.metrics.drift import detection_class_agreement
from classpose_tpu_torch.metrics.pq import (
    compute_binary_pq_metrics,
    compute_multiclass_pq_metrics,
    format_rows,
    write_csv,
)
from classpose_tpu_torch.metrics.stats_utils import get_multi_r2, r2_score
from golden.jax_native import jax_native_geometry  # noqa: F401

KEYS = ("pq", "dq", "sq", "tp", "fp", "fn", "precision", "recall", "f1",
        "iou_sum")


def _pairs(n_images=3, S=64, seed=0):
    """GT and predictions (H, W, 2) [instance, class] with shifted,
    dropped, merged and unlabelled cells, so every count is non-zero."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    yy, xx = np.mgrid[:S, :S]
    for _ in range(n_images):
        gt = np.zeros((S, S, 2), np.int32)
        pr = np.zeros((S, S, 2), np.int32)
        k = 0
        for cy in range(6, S - 6, 13):
            for cx in range(6, S - 6, 13):
                k += 1
                r = rng.integers(3, 6)
                disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                gt[disc] = (k, rng.integers(0, 5))  # class 0: unlabelled
                if rng.uniform() < 0.15:
                    continue  # missed
                dy, dx = rng.integers(-2, 3, 2)
                moved = (yy - cy - dy) ** 2 + (xx - cx - dx) ** 2 <= r * r
                cls = gt[cy, cx, 1] if rng.uniform() < 0.8 else \
                    rng.integers(1, 5)
                pr[moved] = (k + 100, cls)
        pr[rng.integers(0, S - 4):, :4] = (999, 2)  # a false positive
        gts.append(gt)
        preds.append(pr)
    return gts, preds


@pytest.mark.parametrize("no_border", [False, True])
def test_multiclass_pq_matches_jax(no_border):
    gts, preds = _pairs()
    ref_g, ref_i = jax_multiclass(gts, preds, nr_classes=4,
                                  no_border_instances=no_border)
    got_g, got_i = compute_multiclass_pq_metrics(
        gts, preds, nr_classes=4, no_border_instances=no_border)
    assert [r["class_id"] for r in got_g] == list(ref_g["class_id"])
    for k in KEYS:
        np.testing.assert_allclose([r[k] for r in got_g], ref_g[k],
                                   atol=1e-6)
    assert list(got_i[0]) == list(ref_i.columns)
    for k in ref_i.columns:
        np.testing.assert_allclose([r[k] for r in got_i], ref_i[k],
                                   atol=1e-6)
    assert got_g[-1]["tp"] > 0 and got_g[-1]["fp"] > 0


def test_multiclass_spawn_pool_matches_serial():
    gts, preds = _pairs(n_images=4, seed=2)
    serial = compute_multiclass_pq_metrics(gts, preds, nr_classes=4)
    pooled = compute_multiclass_pq_metrics(gts, preds, nr_classes=4,
                                           n_workers=2)
    assert serial == pooled


def test_binary_pq_matches_jax():
    gts, preds = _pairs(seed=1)
    g = [m[..., 0] for m in gts]
    p = [m[..., 0] for m in preds]
    ref = jax_binary(g, p, no_border_instances=True)
    got = compute_binary_pq_metrics(g, p, no_border_instances=True)
    for k in list(KEYS) + ["avg_iou", "image_id"]:
        np.testing.assert_allclose([r[k] for r in got], ref[k], atol=1e-6)


def test_r2_matches_sklearn():
    import pandas as pd

    rng = np.random.default_rng(0)
    names = ["epithelial", "lymphocyte", "plasma", "neutrophil",
             "eosinophil", "connective"]
    true = {c: rng.integers(0, 50, 12).tolist() for c in names}
    pred = {c: (np.asarray(v) + rng.integers(-5, 6, 12)).tolist()
            for c, v in true.items()}
    pred["plasma"] = true["plasma"]  # a perfect class
    true["eosinophil"] = [3] * 12  # a constant target
    ref = jax_r2(pd.DataFrame(true), pd.DataFrame(pred))
    assert get_multi_r2(true, pred) == pytest.approx(ref, abs=1e-12)
    rows = [{c: true[c][i] for c in names} for i in range(12)]
    assert get_multi_r2(rows, pred) == pytest.approx(ref, abs=1e-12)
    assert r2_score([1, 1], [1, 1]) == 1.0 and r2_score([1, 1], [0, 1]) == 0.0
    with pytest.raises(ValueError):
        get_multi_r2({"bad": [1]}, pred)


def test_csv_writer_and_table(tmp_path):
    rows, _ = compute_multiclass_pq_metrics(*_pairs(seed=3), nr_classes=4)
    write_csv(rows, tmp_path / "m.csv")
    with open(tmp_path / "m.csv") as f:
        back = list(csv.DictReader(f))
    assert [r["class_id"] for r in back] == ["1", "2", "3", "4", "avg"]
    for r, b in zip(rows, back):
        for k in KEYS:
            assert float(b[k]) == float(r[k])
    text = format_rows(rows)
    assert text.splitlines()[0].split() == list(rows[0])
    assert len(text.splitlines()) == 6


def test_drift_agreement_on_itself():
    gts, _ = _pairs(n_images=1)
    d = detection_class_agreement(gts[0][..., 0], gts[0][..., 0],
                                  gts[0][..., 1], gts[0][..., 1])
    assert d["f1"] == 1.0 and d["class_agreement"] == 1.0


# ----------------------------------------------------------------- CLIs

CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
           neck_dim=64, bsize=64)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A tiny fp32 checkpoint, 2 images of 128² (CHW) and labels made from
    the JAX model's own masks with every third cell dropped."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.runner import ClassposeModel as JaxModel

    d = tmp_path_factory.mktemp("evalcli")
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(d / "m.npz"), cfg=cfg)
    rng = np.random.default_rng(5)
    images = rng.uniform(0, 255, size=(2, 3, 128, 128)).astype(np.float32)
    model = JaxModel(pretrained_model=str(d / "m.npz"), precision="fp32")
    labels = []
    for img in images:
        m, _, c, _ = model.eval(img.transpose(1, 2, 0))
        m = np.where(m % 3 == 0, 0, m)
        labels.append(np.stack([m, np.where(m > 0, c, 0)]))
    np.save(d / "images.npy", images)
    np.save(d / "labels.npy", np.stack(labels).astype(np.int32))
    return d


def test_evaluate_cli_matches_jax(dataset, tmp_path):
    from classpose_tpu.entrypoints.run_inference import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.run_inference import main_with_args

    argv = ["--data_path", str(dataset), "--model_path",
            str(dataset / "m.npz")]
    jax_main(argv + ["--output_dir", str(tmp_path / "jax")])
    res = main_with_args(argv + ["--output_dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    ref = np.load(tmp_path / "jax" / "predictions.npy")
    got = np.load(tmp_path / "port" / "predictions.npy")
    assert got.shape == ref.shape == (2, 128, 128, 2)
    assert got.dtype == np.int32
    for g, r in zip(got, ref):
        assert len(np.unique(g[..., 0])) == len(np.unique(r[..., 0])) > 3
        assert ((g[..., 0] > 0) == (r[..., 0] > 0)).mean() >= 0.99
    with open(tmp_path / "jax" / "metrics.csv") as f:
        ref_rows = list(csv.DictReader(f))
    with open(tmp_path / "port" / "metrics.csv") as f:
        got_rows = list(csv.DictReader(f))
    assert [r["class_id"] for r in got_rows] == [r["class_id"]
                                                for r in ref_rows]
    for r, g in zip(ref_rows, got_rows):
        for k in KEYS:
            assert float(g[k]) == pytest.approx(float(r[k]), abs=1e-6)
    assert res["n_images"] == 2 and res["metrics"][0]["pq"] > 0.5


def test_calculate_metrics_cli_matches_jax(dataset, tmp_path):
    """Both CLIs on the same GT and prediction files write the same CSV
    text; the port's table also reproduces the evaluate CLI's numbers."""
    from classpose_tpu.entrypoints.calculate_metrics import (
        main_with_args as jax_main,
    )
    from classpose_tpu_torch.entrypoints.calculate_metrics import (
        main_with_args,
    )
    from classpose_tpu_torch.entrypoints.run_inference import (
        main_with_args as evaluate,
    )

    ev = evaluate(["--data_path", str(dataset), "--model_path",
                   str(dataset / "m.npz"), "--output_dir",
                   str(tmp_path / "ev"), "--device", "cpu"])
    labels = np.load(dataset / "labels.npy")
    np.save(tmp_path / "gt.npy",
            np.stack([labels[:, 0], labels[:, -1]], axis=-1))
    argv = ["--gt_path", str(tmp_path / "gt.npy"), "--pred_path",
            str(tmp_path / "ev" / "predictions.npy")]
    jax_main(argv + ["--output", str(tmp_path / "jax.csv")])
    got = main_with_args(argv + ["--output", str(tmp_path / "port.csv")])
    ref = _read_csv(tmp_path / "jax.csv")
    assert ref == _read_csv(tmp_path / "port.csv")
    for k in KEYS:
        np.testing.assert_allclose([r[k] for r in got],
                                   [float(r[k]) for r in ref], atol=1e-6)
        # the evaluate CLI scores the model's 6 classes, this one the GT's
        assert got[0][k] == pytest.approx(ev["metrics"][0][k], abs=1e-6)
    assert _read_csv(tmp_path / "jax_per_image.csv") == _read_csv(
        tmp_path / "port_per_image.csv")
    # the binary route takes instance maps (N, H, W)
    np.save(tmp_path / "gt_inst.npy", labels[:, 0])
    np.save(tmp_path / "pred_inst.npy",
            np.load(tmp_path / "ev" / "predictions.npy")[..., 0])
    argv = ["--gt_path", str(tmp_path / "gt_inst.npy"), "--pred_path",
            str(tmp_path / "pred_inst.npy"), "--binary"]
    main_with_args(argv + ["--output", str(tmp_path / "b.csv")])
    jax_main(argv + ["--output", str(tmp_path / "jb.csv")])
    for r, g in zip(_read_csv(tmp_path / "jb.csv"),
                    _read_csv(tmp_path / "b.csv")):
        assert float(g["pq"]) == pytest.approx(float(r["pq"]), abs=1e-6)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_entry_points_are_registered():
    import tomllib
    from pathlib import Path

    data = tomllib.loads((Path(__file__).resolve().parents[1]
                          / "pyproject.toml").read_text())
    scripts = data["project"]["scripts"]
    assert scripts["classpose-evaluate-torch"] == (
        "classpose_tpu_torch.entrypoints.run_inference:main_with_args")
    assert scripts["classpose-calculate-metrics-torch"] == (
        "classpose_tpu_torch.entrypoints.calculate_metrics:main_with_args")
    out = subprocess.run(
        [sys.executable, "-m",
         "classpose_tpu_torch.entrypoints.calculate_metrics", "--help"],
        capture_output=True, text=True, check=True).stdout
    assert "--label_map" in out
