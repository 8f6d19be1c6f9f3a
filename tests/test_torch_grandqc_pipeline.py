"""The WSI CLI with GrandQC tissue and artefact detection, as QuPath calls
it: the port's ``pipeline.predict_wsi.main`` against JAX ``main`` on the
same ``.npy`` slide and tiny checkpoint, fp32 on the CPU, with the oracle
predict functions of ``tests/test_pipeline_qc_integration.py`` in place
of both packages' ``make_unetpp_predict_fn``; then the detect CLIs, the
GrandQC kind of the convert CLI, and one real-net run of the port's
tissue CLI.

The slide is ``tests/test_torch_pipeline.py``'s with its right third
blank (no tissue: tiles there are never read) and a dark pen mark (an
artefact: ``--filter_artefacts`` drops the cells under it). Its tissue
thumbnail is one 512² patch and its artefact thumbnail one too. The QC
GeoJSON geometry must be equal, and the density rows' areas (tissue,
artefact, ROI ∩ artefact) equal to 1e-9. Cells are compared as
``tests/test_torch_pipeline.py`` compares them (counts within 0.5%, every
port cell within 1 px of a JAX cell of the same class): deduplication is
greedy over the features in the order the post-processing threads finish
them, so either package's run may keep the other of two near-duplicate
cells (398 and 397 cells for one ROI run of JAX ``main``)."""

import csv
import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from classpose_tpu.io.array_reader import synthetic_wsi
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.pipeline.predict_wsi import main as jax_main
from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
from test_pipeline_qc_integration import _artefact_fn, _tissue_fn
from test_torch_grandqc import fast_jax_init, smp_state_dict  # noqa: F401
from test_torch_pipeline import CFG, LABELS, _args
from golden.jax_native import jax_native_geometry  # noqa: F401


def _oracle(path, classes=2, **kw):
    return _tissue_fn if classes == 2 else _artefact_fn


def _roi(tmp):
    """Two ROI classes whose tile grids meet no other grid: each side is
    256 + 240k px (the ROI grid's last tile, shifted to the ROI's edge,
    then falls on the grid's step), and the grids' 32 px margins leave a
    gap between the ROIs. Tiles of other origins would find the same cell
    twice in different contexts, and greedy dedup would keep one or the
    other as the post-processing threads happen to finish."""
    def sq(x0, y0, x1, y1, name):
        return {"type": "Feature",
                "geometry": {"type": "Polygon", "coordinates": [[
                    [x0, y0], [x1, y0], [x1, y1], [x0, y1], [x0, y0]]]},
                "properties": {"classification": {"name": name}}}

    path = tmp / "roi.geojson"
    path.write_text(json.dumps({"type": "FeatureCollection", "features": [
        sq(0, 0, 496, 496, "Left"), sq(600, 0, 1096, 736, "Right")]}))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import classpose_tpu.grandqc.artefact as jart
    import classpose_tpu.grandqc.tissue as jtis
    import classpose_tpu_torch.grandqc.tissue as ptis

    tmp = tmp_path_factory.mktemp("qc")
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    img = slide._level0.copy()
    img[:, 760:] = 250                 # no tissue
    img[120:300, 150:330] = 35         # a pen mark
    np.save(tmp / "slide.npy", img)
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    mp = pytest.MonkeyPatch()
    mp.setenv("WSI_READER", "array")
    for mod in (jtis, jart, ptis):
        mp.setattr(mod, "make_unetpp_predict_fn", _oracle)
    out = {}
    try:
        for name, roi in (("plain", None), ("roi", _roi(tmp))):
            res = {}
            for pkg, main, dev in (("jax", jax_main, None),
                                   ("port", port_main, "cpu")):
                a = _args(tmp, tmp / name / pkg, dev)
                a.tissue_detection_model_path = "tissue.npz"
                a.artefact_detection_model_path = "artefact.npz"
                a.filter_artefacts = True
                a.min_area = 400
                a.roi_geojson = roi
                res[pkg] = main(a)
            out[name] = res
    finally:
        mp.undo()
    return tmp, out


def _features(path):
    with open(path) as f:
        return json.load(f)["features"]


def _geometry(path):
    return [(f["geometry"], f["properties"]["classification"])
            for f in _features(path)]


@pytest.mark.parametrize("run", ["plain", "roi"])
@pytest.mark.parametrize("kind", ["tissue_contours", "artefact_contours"])
def test_qc_geojson_equal(runs, run, kind):
    tmp, _ = runs
    ref = _geometry(tmp / run / "jax" / f"slide_{kind}.geojson")
    got = _geometry(tmp / run / "port" / f"slide_{kind}.geojson")
    assert ref and got == ref


@pytest.mark.parametrize("run", ["plain", "roi"])
def test_cells_match(runs, run):
    tmp, out = runs
    ref, got = out[run]["jax"], out[run]["port"]
    assert ref["n_cells"] > 20
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]
    assert got["n_tiles"] == ref["n_tiles"]
    if run == "plain":  # the blank third is skipped (12 tiles without QC)
        assert got["n_tiles"] < 12

    def pts(pkg):
        feats = _features(tmp / run / pkg / "slide_cell_centroids.geojson")
        return (np.array([f["geometry"]["coordinates"] for f in feats]),
                [f["properties"]["classification"]["name"] for f in feats])

    (rp, rn), (gp, gn) = pts("jax"), pts("port")
    dist, idx = cKDTree(rp).query(gp, distance_upper_bound=1.0)
    assert np.mean([np.isfinite(d) and gn[i] == rn[j]
                    for i, (d, j) in enumerate(zip(dist, idx))]) >= 0.99
    # no cell is left under the pen mark (level-0 box 150..330 × 120..300)
    assert not ((gp[:, 0] > 160) & (gp[:, 0] < 320) & (gp[:, 1] > 130)
                & (gp[:, 1] < 290)).any()
    assert (gp[:, 0] < 770).all()


@pytest.mark.parametrize("run", ["plain", "roi"])
def test_density_rows_equal(runs, run):
    tmp, _ = runs

    def rows(pkg):
        with open(tmp / run / pkg / "slide_cellular_densities.csv") as f:
            return list(csv.DictReader(f))

    ref, got = rows("jax"), rows("port")
    assert [(r["region"], r["cell_class"]) for r in got] == \
        [(r["region"], r["cell_class"]) for r in ref]
    n_ref = sum(int(r["count"]) for r in ref)
    assert sum(abs(int(g["count"]) - int(r["count"]))
               for r, g in zip(ref, got)) <= 0.005 * n_ref
    for r, g in zip(ref, got):  # the same area under every row
        if int(r["count"]) and int(g["count"]):
            assert float(g["density"]) / int(g["count"]) == pytest.approx(
                float(r["density"]) / int(r["count"]), rel=1e-9)
    if run == "roi":
        assert {r["region"] for r in got} == {"Left", "Right"}


def test_store_holds_the_qc_groups(runs):
    """The JAX package's independent zarr checker on the port's store,
    with its tissue and artefact groups; the JAX store's groups and
    arrays."""
    from classpose_tpu.io.zarr_spec_check import validate_spatialdata_store

    tmp, out = runs
    got = validate_spatialdata_store(
        tmp / "plain" / "port" / "slide_spatialdata.zarr")
    ref = validate_spatialdata_store(
        tmp / "plain" / "jax" / "slide_spatialdata.zarr")
    assert (got["n_groups"], got["n_arrays"], got["tables"]) == \
        (ref["n_groups"], ref["n_arrays"], ref["tables"])
    assert got["n_cells"] == out["plain"]["port"]["n_cells"]
    for g in ("tissue_contours", "artefact_contours"):
        assert (tmp / "plain" / "port" / "slide_spatialdata.zarr" / "shapes"
                / g / "geojson").is_dir()


def test_no_tissue_returns_no_cells(runs, monkeypatch):
    import classpose_tpu_torch.grandqc.tissue as ptis

    tmp, _ = runs
    monkeypatch.setenv("WSI_READER", "array")
    monkeypatch.setattr(ptis, "make_unetpp_predict_fn",
                        lambda *a, **k: lambda b: np.zeros(b.shape[:3],
                                                           np.int32))
    a = _args(tmp, tmp / "none", "cpu")
    a.tissue_detection_model_path = "tissue.npz"
    assert port_main(a) == {"n_cells": 0}


# ------------------------------------------------------------------ CLIs

def test_detect_clis_match_jax(runs, monkeypatch):
    import classpose_tpu.grandqc.artefact as jart
    import classpose_tpu.grandqc.tissue as jtis
    import classpose_tpu_torch.grandqc.tissue as ptis
    from classpose_tpu.entrypoints import detect_artefacts as jda
    from classpose_tpu.entrypoints import detect_tissue as jdt
    from classpose_tpu_torch.entrypoints import detect_artefacts as pda
    from classpose_tpu_torch.entrypoints import detect_tissue as pdt

    tmp, _ = runs
    monkeypatch.setenv("WSI_READER", "array")
    for mod in (jtis, jart, ptis):
        monkeypatch.setattr(mod, "make_unetpp_predict_fn", _oracle)
    slide = str(tmp / "slide.npy")
    for pkg, dt, da, extra in (("jax", jdt, jda, []),
                               ("port", pdt, pda, ["--device", "cpu"])):
        out = str(tmp / "cli" / pkg)
        dt.main_with_args(["--slide_path", slide, "--model_path", "t.npz",
                           "--output_folder", out, "--min_area", "400"]
                          + extra)
        da.main_with_args(["--slide_path", slide, "--model_path", "a.npz",
                           "--tissue_model_path", "t.npz",
                           "--output_folder", out + "_art"] + extra)
    for sub, kind in (("", "tissue"), ("_art", "tissue"),
                      ("_art", "artefact")):
        name = f"slide_{kind}_contours.geojson"
        assert _geometry(tmp / "cli" / f"port{sub}" / name) == \
            _geometry(tmp / "cli" / f"jax{sub}" / name)
    with pytest.raises(ValueError, match="model_path or predict_fn"):
        pda.main_with_args(["--slide_path", slide, "--model_path", "a.npz",
                            "--output_folder", str(tmp / "cli" / "x"),
                            "--device", "cpu"])


def test_convert_cli_grandqc_writes_what_jax_writes(tmp_path, fast_jax_init):
    """``--kind grandqc`` on an smp checkpoint: the port's CLI and the
    JAX one write the same ``.npz``; the class count comes from the head;
    ``--strict`` refuses a leftover tensor in both."""
    from classpose_tpu.entrypoints.convert_weights import (
        main_with_args as jax_cli,
    )
    from classpose_tpu_torch.entrypoints.convert_weights import (
        main_with_args as port_cli,
    )

    sd = smp_state_dict(2, seed=11)
    pt = tmp_path / "tissue.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               pt)
    port_cli(["--input", str(pt), "--output", str(tmp_path / "port.npz"),
              "--kind", "grandqc"])
    jax_cli(["--input", str(pt), "--output", str(tmp_path / "jax.npz"),
             "--kind", "grandqc"])
    extra = tmp_path / "extra.pt"
    torch.save({**torch.load(pt), "aux.weight": torch.zeros(3)}, extra)
    for cli in (port_cli, jax_cli):
        with pytest.raises(ValueError, match="unconsumed"):
            cli(["--input", str(extra), "--output", str(tmp_path / "x.npz"),
                 "--kind", "grandqc", "--strict"])
    assert not (tmp_path / "x.npz").exists()
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)


def test_real_net_tissue_cli(tmp_path, monkeypatch):
    """The tissue CLI with a real (random, seeded) 2-class net on a 512²
    thumbnail: the port's CLI writes the GeoJSON that the port's own
    stage, run with the JAX net's argmax as its predict_fn, gives."""
    import jax

    import classpose_tpu.grandqc.nets as jnets
    from classpose_tpu.nn.convert import unflatten_params
    from classpose_tpu_torch.entrypoints import detect_tissue as pdt
    from classpose_tpu_torch.grandqc import detect_tissue_wsi
    from classpose_tpu_torch.grandqc.convert import (
        grandqc_params_to_jax,
        save_grandqc_npz,
    )
    from classpose_tpu_torch.grandqc.nets import UnetPlusPlusConfig
    from classpose_tpu_torch.io.tiff_reader import TiffSlide
    from classpose_tpu_torch.io.tiff_writer import write_tiled_tiff

    monkeypatch.delenv("WSI_READER", raising=False)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in smp_state_dict(2, seed=5).items()
          if not k.endswith("num_batches_tracked")}
    save_grandqc_npz(sd, str(tmp_path / "t.npz"), UnetPlusPlusConfig())
    rng = np.random.default_rng(0)
    img = np.full((2048, 2048, 3), 240, np.uint8)
    img[400:1600, 300:1700] = rng.integers(120, 230, (1200, 1400, 3))
    write_tiled_tiff(tmp_path / "s.svs", img, mpp=2.5)  # MPP 10: 512²
    res = pdt.main_with_args(["--slide_path", str(tmp_path / "s.svs"),
                              "--model_path", str(tmp_path / "t.npz"),
                              "--output_folder", str(tmp_path / "out"),
                              "--device", "cpu"])
    assert res["thumb"].shape == (512, 512, 3)

    net = jnets.UnetPlusPlus(jnets.UnetPlusPlusConfig(classes=2))
    tree = unflatten_params(grandqc_params_to_jax(sd))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)

    @jax.jit
    def fwd(x):
        x = (x.astype(np.float32) / 255.0 - mean) / std
        return net.apply(tree, x.transpose(0, 3, 1, 2)).argmax(1)

    ref = detect_tissue_wsi(TiffSlide(str(tmp_path / "s.svs")),
                            predict_fn=lambda b: np.asarray(
                                fwd(b)).astype(np.int32))
    assert (res["mask"] == ref["mask"]).mean() >= 0.999
    assert os.path.exists(tmp_path / "out" / "s_tissue_contours.geojson")
