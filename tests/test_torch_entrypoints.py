"""The port's checkpoint CLIs against the JAX package's:
``classpose-convert-weights-torch``, ``classpose-parity-check-torch``,
``classpose-predict-wsi-cpsam-torch``, and a built-in
``--model_config`` resolving to ``$CLASSPOSE_MODEL_DIR/conic.pt``, all on
the CPU at a small size.

WSI cells are compared as ``tests/test_torch_pipeline.py`` compares them
(counts within 0.5%, ≥ 99% of centroids within 1 px with the same
class)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from classpose_tpu.nn import convert as jconv
from classpose_tpu_torch.entrypoints import convert_weights as pcw
from classpose_tpu_torch.entrypoints import parity_check as ppc
from test_torch_checkpoints import HEADS, replica, structured_pt
from golden.jax_native import jax_native_geometry  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt")
    paths = {}
    for i, (name, (n, st)) in enumerate(HEADS.items()):
        paths[name] = str(d / f"{name}.pt")
        torch.save(replica(n, st, seed=i, ps=8, bsize=64, embed_dim=64,
                           neck_dim=32).state_dict(), paths[name])
    return paths


# ------------------------------------------------------- convert-weights

@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam"])
def test_convert_cli_writes_what_jax_writes(checkpoints, tmp_path, name):
    from classpose_tpu.entrypoints.convert_weights import (
        main_with_args as jax_cli,
    )

    pcw.main_with_args(["--input", checkpoints[name], "--output",
                        str(tmp_path / "port.npz")])
    jax_cli(["--input", checkpoints[name], "--output",
             str(tmp_path / "jax.npz")])
    got, got_meta = jconv.load_npz_checkpoint(str(tmp_path / "port.npz"))
    ref, ref_meta = jconv.load_npz_checkpoint(str(tmp_path / "jax.npz"))
    assert got_meta == ref_meta
    got, ref = jconv.flatten_params(got), jconv.flatten_params(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(
            got[k], ref[k]), k


def test_convert_cli_refuses_grandqc(checkpoints, tmp_path):
    """``--kind grandqc`` on a classpose checkpoint: both CLIs refuse it
    (the GrandQC encoder's tensors are missing) and write nothing."""
    from classpose_tpu.entrypoints.convert_weights import (
        main_with_args as jax_cli,
    )

    for cli in (pcw.main_with_args, jax_cli):
        with pytest.raises(KeyError, match="encoder.conv_stem.weight"):
            cli(["--input", checkpoints["conv6"], "--output",
                 str(tmp_path / "x.npz"), "--kind", "grandqc"])
    assert not (tmp_path / "x.npz").exists()


# ---------------------------------------------------------- parity-check

@pytest.mark.parametrize("name", ["conv6", "unet4", "cpsam"])
def test_parity_check_passes(checkpoints, tmp_path, name):
    out = tmp_path / "report.json"
    report = ppc.main_with_args([
        "--checkpoint", checkpoints[name], "--n_tiles", "2",
        "--tile_size", "64", "--niter", "20", "--output", str(out),
        "--device", "cpu"])
    assert json.loads(out.read_text())["checkpoint"] == checkpoints[name]
    pl = report["per_layer"]
    assert pl["missing_keys"] == [] and pl["unexpected_keys"] == []
    heads = ["out_class"] if HEADS[name][0] > 1 else []
    assert sorted(pl["layers"]) == sorted(
        ["patch_embed", "block_0", "block_1", "encoder", "out", *heads])
    for layer, diff in pl["layers"].items():
        assert diff <= 2e-4, (layer, diff)
    assert report["logit_parity_pass"] is True
    assert report["config"]["n_cell_classes"] == HEADS[name][0]
    assert "skipped" in report["manifest_diff"]
    assert len(report["n_cells_per_tile"]) == 2
    np.testing.assert_array_equal(ppc.synthetic_tiles(2, 64),
                                  ppc.synthetic_tiles(2, 64))


def test_parity_check_directory_mode(checkpoints, tmp_path):
    import shutil

    d = tmp_path / "ckpts"
    d.mkdir()
    shutil.copy(checkpoints["conv6"], d / "model_a.pt")
    shutil.copy(checkpoints["cpsam"], d / "model_b.pt")
    (d / "broken.pt").write_bytes(b"not a checkpoint")
    out = tmp_path / "consolidated.json"
    report = ppc.main_with_args([
        "--checkpoint", str(d), "--n_tiles", "1", "--tile_size", "64",
        "--niter", "10", "--output", str(out), "--device", "cpu"])
    saved = json.loads(out.read_text())
    assert set(saved["checkpoints"]) == {"model_a.pt", "model_b.pt",
                                         "broken.pt"}
    for name in ("model_a.pt", "model_b.pt"):
        assert saved["summary"][name]["logit_parity_pass"] is True
    assert "error" in saved["summary"]["broken.pt"]
    assert report["summary"].keys() == saved["summary"].keys()


def test_parity_check_reference_masks(checkpoints, monkeypatch):
    """Detection F1 and class agreement against reference masks, equal to
    the JAX package's metric on the same masks."""
    from classpose_tpu.entrypoints.parity_check import (
        detection_f1 as jax_f1,
    )
    from classpose_tpu_torch.runner import ClassposeModel

    masks = np.zeros((64, 64), np.int32)
    masks[5:20, 5:20] = 1
    masks[30:45, 30:45] = 2
    masks[50:60, 5:15] = 3
    cms = np.where(masks > 0, (masks % 3) + 1, 0).astype(np.int32)
    monkeypatch.setattr(ClassposeModel, "eval",
                        lambda self, x, **kw: (masks, None, cms, None))
    tiles = ppc.synthetic_tiles(1, 64)
    rep = ppc.run_parity(checkpoints["conv6"], tiles,
                         reference_masks=np.asarray([masks]),
                         reference_class_masks=np.asarray([cms]), niter=20,
                         device="cpu")
    assert rep["detection"]["f1"] == 1.0
    assert rep["classification_pixel_agreement"] == 1.0
    ref2 = masks.copy()
    ref2[50:60, 5:15] = 0
    rep2 = ppc.run_parity(checkpoints["conv6"], tiles,
                          reference_masks=np.asarray([ref2]), niter=20,
                          device="cpu")
    assert rep2["detection"]["f1"] == pytest.approx(0.8)
    assert ppc.detection_f1(ref2, masks) == pytest.approx(
        jax_f1(ref2, masks))


# ------------------------------------------------------------- the WSI CLIs

@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    from classpose_tpu.io.array_reader import synthetic_wsi

    tmp = tmp_path_factory.mktemp("slide")
    s, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                         mpp=0.4)
    np.save(tmp / "slide.npy", s._level0)
    return tmp / "slide.npy"


def _cells(path):
    with open(path) as f:
        feats = json.load(f)["features"]
    return (np.array([f["geometry"]["coordinates"] for f in feats]),
            [f["properties"]["classification"]["name"] for f in feats])


def assert_same_cells(got_path, ref_path, exact=False):
    pts, names = _cells(got_path)
    ref_pts, ref_names = _cells(ref_path)
    assert len(ref_pts) >= 100
    assert abs(len(pts) - len(ref_pts)) <= 0.005 * len(ref_pts)
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= (1.0 if exact else 0.99)
    if exact:
        assert len(pts) == len(ref_pts)


WSI_ARGS = ["--tile_size", "256", "--overlap", "64", "--batch_size", "8",
            "--mpp", "0.4", "--inference_threads", "2"]


def test_cpsam_cli_matches_jax(slide, tmp_path, monkeypatch):
    """A tiny single-class ``.pt``: the port's CLI builds its model from
    the file; the JAX CLI gets the JAX model of the same file's params
    (the JAX package builds a ``.pt``'s net at the default ViT-L
    geometry)."""
    from classpose_tpu.entrypoints.predict_wsi_cpsam import (
        build_parser as jax_parser,
        main as jax_main,
    )
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.runner import ClassposeModel as JaxModel
    from classpose_tpu_torch.entrypoints.predict_wsi_cpsam import (
        build_parser,
        main_with_args,
    )
    from test_torch_checkpoints import CELL_CFG

    monkeypatch.setenv("WSI_READER", "array")
    pt = str(tmp_path / "cpsam.pt")
    structured_pt(pt, n_cell_classes=1)
    argv = ["--model_path", pt, "--slide_path", str(slide), "--precision",
            "fp32", *WSI_ARGS]
    assert {a.dest for a in build_parser()._actions} == \
        {a.dest for a in jax_parser()._actions}
    got = main_with_args(argv + ["--output_folder", str(tmp_path / "port"),
                                 "--device", "cpu"])
    jax_model = JaxModel(cfg=JaxCfg(**{**CELL_CFG, "n_cell_classes": 1}),
                         params=jconv.load_params(pt), precision="fp32")
    ref = jax_main(jax_parser().parse_args(
        argv + ["--output_folder", str(tmp_path / "jax")]),
        model_override=jax_model)
    assert got["n_tiles"] == ref["n_tiles"] == 12
    assert_same_cells(tmp_path / "port" / "slide_cell_centroids.geojson",
                      tmp_path / "jax" / "slide_cell_centroids.geojson")
    assert set(_cells(tmp_path / "port" /
                      "slide_cell_centroids.geojson")[1]) == {"cell"}


def test_builtin_config_loads_its_pt(slide, tmp_path):
    """``--model_config conic`` with ``CLASSPOSE_MODEL_DIR`` on a directory
    holding a tiny ``conic.pt`` runs the WSI CLI (``python -m``, a process
    of its own, which reads the variable at import) to GeoJSON; the same
    CLI on the ``.npz`` that ``classpose-convert-weights-torch`` writes
    from that file finds the same cells."""
    from classpose_tpu_torch.entrypoints.predict_wsi import main_with_args

    models = tmp_path / "models"
    models.mkdir()
    structured_pt(models / "conic.pt")
    env = {**os.environ, "CLASSPOSE_MODEL_DIR": str(models),
           "WSI_READER": "array", "PYTHONPATH": str(ROOT)}
    subprocess.run(
        [sys.executable, "-m", "classpose_tpu_torch.entrypoints.predict_wsi",
         "--model_config", "conic", "--slide_path", str(slide),
         "--output_folder", str(tmp_path / "pt"), "--device", "cpu",
         "--precision", "fp32", *WSI_ARGS],
        cwd=ROOT, env=env, check=True, capture_output=True, text=True)
    pcw.main_with_args(["--input", str(models / "conic.pt"), "--output",
                        str(tmp_path / "conic.npz")])
    (tmp_path / "c.yaml").write_text(
        f"path: {tmp_path}/conic.npz\nmpp: 0.5\ncell_types: "
        "[Neutrophil, Epithelial, Lymphocyte, Plasma cell, Eosinophil, "
        "Connective]\n")
    old = os.environ.get("WSI_READER")
    os.environ["WSI_READER"] = "array"
    try:
        main_with_args(["--model_config", str(tmp_path / "c.yaml"),
                        "--slide_path", str(slide), "--output_folder",
                        str(tmp_path / "npz"), "--device", "cpu",
                        "--precision", "fp32", *WSI_ARGS])
    finally:
        if old is None:
            os.environ.pop("WSI_READER")
        else:
            os.environ["WSI_READER"] = old
    assert_same_cells(tmp_path / "pt" / "slide_cell_centroids.geojson",
                      tmp_path / "npz" / "slide_cell_centroids.geojson",
                      exact=True)
    names = set(_cells(tmp_path / "pt" / "slide_cell_centroids.geojson")[1])
    assert names <= {"Neutrophil", "Epithelial", "Lymphocyte",
                     "Plasma cell", "Eosinophil", "Connective"}


def test_evaluate_cli_takes_pt(tmp_path):
    """``classpose-evaluate-torch --model_path x.pt`` builds the model the
    file describes and scores its predictions."""
    from classpose_tpu_torch.entrypoints.run_inference import main_with_args

    pt = tmp_path / "m.pt"
    structured_pt(pt)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(2, 3, 128, 128)).astype(np.float32)
    labels = np.zeros((2, 2, 128, 128), np.float32)
    labels[:, 0, 10:30, 10:30] = 1
    labels[:, 1, 10:30, 10:30] = 2
    np.save(tmp_path / "images.npy", images)
    np.save(tmp_path / "labels.npy", labels)
    res = main_with_args(["--data_path", str(tmp_path), "--model_path",
                          str(pt), "--output_dir", str(tmp_path / "out"),
                          "--device", "cpu", "--batch_size", "4"])
    preds = np.load(tmp_path / "out" / "predictions.npy")
    assert preds.shape == (2, 128, 128, 2) and res["n_images"] == 2
    assert preds[..., 0].max() >= 5


def test_console_scripts_name_the_port_clis():
    """``pyproject.toml`` names the training and dataset CLIs of the port
    beside the JAX package's, and each target imports."""
    import importlib
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    want = {
        "classpose-train-torch":
            "classpose_tpu_torch.entrypoints.run_training:main_with_args",
        "classpose-dataset-to-hdf5-torch":
            "classpose_tpu_torch.entrypoints.dataset_to_hdf5:main_with_args",
    }
    for name, target in want.items():
        assert scripts[name] == target
        module, fn = target.split(":")
        assert callable(getattr(importlib.import_module(module), fn))
    assert scripts["classpose-train"].startswith("classpose_tpu.")
