"""The whole WSI pipeline: JAX ``pipeline.predict_wsi.main`` against the
port's on the same ``.npy`` slide (written by the JAX ``synthetic_wsi``)
and the same tiny ``perturbed_structured_params`` checkpoint (written by
the JAX ``save_params``), fp32, 256² tiles, ``--output_type csv
spatialdata``.

Cells are compared as cells: equal counts, ≥ 99% of the port's cells
within 1 px of a JAX cell's centroid with the same class, equal density
counts. The counts may differ by at most 0.5%: the two packages' flow
samplers round differently in the last bit below 384² (see
``tests/test_torch_slice.py``), which can move a pixel across a basin
boundary and, rarely, split or merge an instance."""

import csv
import json

import numpy as np
import pytest
from scipy.spatial import cKDTree

from classpose_tpu.io.array_reader import synthetic_wsi
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.pipeline.predict_wsi import main as jax_main
from classpose_tpu_torch.io.zarrlite import read_zarr_array
from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
from golden.jax_native import jax_native_geometry  # noqa: F401

CFG = dict(n_cell_classes=6, ps=4, embed_dim=64, depth=2, num_heads=4,
           neck_dim=64, bsize=64)
LABELS = ["A", "B", "C", "D", "E", "F"]


def _args(tmp, out, device):
    return type("Args", (), dict(
        model_config=str(tmp / "config.yaml"),
        slide_path=str(tmp / "slide.npy"), output_folder=str(out),
        tile_size=256, overlap=64, batch_size=8, precision="fp32",
        tta=False, roi_geojson=None, output_type=["csv", "spatialdata"],
        tissue_detection_model_path=None,
        artefact_detection_model_path=None, filter_artefacts=False,
        roi_class_priority=None, min_area=0, mpp=0.4, device=device,
        inference_threads=2,
    ))()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import os

    tmp = tmp_path_factory.mktemp("wsi")
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    np.save(tmp / "slide.npy", slide._level0)
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    old = os.environ.get("WSI_READER")
    os.environ["WSI_READER"] = "array"
    try:
        ref = jax_main(_args(tmp, tmp / "jax", None))
        got = port_main(_args(tmp, tmp / "port", "cpu"))
    finally:
        if old is None:
            os.environ.pop("WSI_READER")
        else:
            os.environ["WSI_READER"] = old
    return tmp, ref, got


def _centroids(path):
    with open(path) as f:
        feats = json.load(f)["features"]
    return (np.array([f["geometry"]["coordinates"] for f in feats]),
            [f["properties"]["classification"]["name"] for f in feats])


def test_same_tiles_and_cells(runs):
    _, ref, got = runs
    assert got["n_tiles"] == ref["n_tiles"] == 12
    assert ref["n_cells"] >= 100
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]


def test_centroids_and_classes_match(runs):
    tmp, _, _ = runs
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= 0.99


def test_densities_counts_match(runs):
    tmp, _, got = runs

    def counts(path):
        with open(path) as f:
            return [(r["region"], r["cell_class"], int(r["count"]))
                    for r in csv.DictReader(f)]

    ref_c = counts(tmp / "jax" / "slide_cellular_densities.csv")
    got_c = counts(tmp / "port" / "slide_cellular_densities.csv")
    assert [r[:2] for r in got_c] == [r[:2] for r in ref_c]
    assert [r[2] for r in got_c] == [r[2] for r in ref_c]
    assert sum(r[2] for r in got_c) == got["n_cells"]


def test_zarr_store_holds_the_cells(runs):
    tmp, _, got = runs
    z = tmp / "port" / "slide_spatialdata.zarr"
    x = read_zarr_array(z / "points" / "cell_centroids" / "x")
    cls = read_zarr_array(z / "points" / "cell_centroids" /
                          "classification")
    assert len(x) == len(cls) == got["n_cells"]
    X = read_zarr_array(z / "tables" / "cellular_densities" / "X")
    assert X.shape == (len(LABELS), 2) and X[:, 0].sum() == got["n_cells"]


def test_store_passes_the_jax_spec_check(runs):
    """The JAX package's independent zarr v2 / AnnData checker on the
    port's store: the JAX store's group and array counts, and the port's
    cells."""
    from classpose_tpu.io.zarr_spec_check import validate_spatialdata_store

    tmp, _, got = runs
    port = validate_spatialdata_store(tmp / "port" / "slide_spatialdata.zarr")
    ref = validate_spatialdata_store(tmp / "jax" / "slide_spatialdata.zarr")
    assert port["n_cells"] == got["n_cells"]
    assert (port["n_groups"], port["n_arrays"], port["tables"]) == \
        (ref["n_groups"], ref["n_arrays"], ref["tables"]) == \
        (15, 9, ["tables/cellular_densities"])
