"""The WSI pipeline's host modules against the JAX package's on identical
inputs, exact except for random UUIDs: polygons from masks, dedup, the
slide loader's tile lists, the tile filter, the R-tree, ``make_valid``,
GeoJSON, CSV and zarr outputs, the colormap, the YAML config reader, the
bilinear resize (against cv2) and the synthetic slide."""

import json

import cv2
import numpy as np
import pandas as pd
import pytest
import yaml

import classpose_tpu.geometry as jgeom
import classpose_tpu.io.array_reader as jarr
import classpose_tpu.model_configs as jcfg
import classpose_tpu.pipeline.outputs as jout
import classpose_tpu.pipeline.postprocess as jpost
import classpose_tpu.pipeline.slide_loader as jload
import classpose_tpu.pipeline.tile_filter as jfilt
import classpose_tpu_torch.geometry as pgeom
import classpose_tpu_torch.io.array_reader as parr
import classpose_tpu_torch.model_configs as pcfg
import classpose_tpu_torch.pipeline.outputs as pout
import classpose_tpu_torch.pipeline.postprocess as ppost
import classpose_tpu_torch.pipeline.slide_loader as pload
import classpose_tpu_torch.pipeline.tile_filter as pfilt
from golden.jax_native import jax_native_geometry  # noqa: F401

LABELS = ["Tumour", "Stroma", "Lymphocyte", "Other"]


def _label_image(seed=0, size=200):
    """Instance ids (ellipses, a two-component instance, a holed ring,
    single pixels) and a class map constant per instance."""
    rng = np.random.default_rng(seed)
    m = np.zeros((size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    k = 0
    for _ in range(40):
        cy, cx = rng.integers(8, size - 8, 2)
        a, b = rng.uniform(2, 7, 2)
        t = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        inside = ((u / a) ** 2 + (v / b) ** 2 <= 1) & (m == 0)
        if inside.sum() >= 3:
            k += 1
            m[inside] = k
    k += 1
    m[2:5, 2:5] = k
    m[2:5, 12:15] = k  # a second component of the same instance
    k += 1
    ring = ((yy - 180) ** 2 + (xx - 20) ** 2 <= 64) \
        & ((yy - 180) ** 2 + (xx - 20) ** 2 > 9)
    m[ring & (m == 0)] = k
    k += 1
    m[100, 199] = k  # a single pixel on the border
    cls = (rng.integers(1, len(LABELS) + 1, k + 1) * (np.arange(k + 1) > 0))
    return m, cls[m].astype(np.int32)


def _mask_ids(features):
    return [dict(f, id="X") for f in features]


@pytest.fixture(scope="module")
def tile_cells():
    m, c = _label_image()
    args = (m, c, (1000.0, 2000.0), 1.25, LABELS)
    return jpost.process_tile(*args), ppost.process_tile(*args)


def test_process_tile_matches(tile_cells):
    (ref, ref_inv), (got, inv) = tile_cells
    assert inv == ref_inv and len(got) == len(ref) >= 30
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for key in ("coords", "area", "perimeter", "centroid", "class_int",
                    "label", "color"):
            assert a[key] == b[key], key


def test_process_tile_without_classes():
    m, _ = _label_image(1)
    ref, _ = jpost.process_tile(m, None, (0.0, 0.0), 1.0, None)
    got, _ = ppost.process_tile(m, None, (0.0, 0.0), 1.0, None)
    assert [dict(c, id=0) for c in got] == [dict(c, id=0) for c in ref]


def test_feature_collection_text_matches(tile_cells, tmp_path):
    (ref, _), (got, _) = tile_cells
    feats_ref = _mask_ids([jout.to_geojson_polygon(c) for c in ref])
    feats = _mask_ids([pout.to_geojson_polygon(c) for c in got])
    jout.write_feature_collection(feats_ref, tmp_path / "ref.geojson",
                                  workers=0)
    pout.write_feature_collection(feats, tmp_path / "got.geojson")
    assert (tmp_path / "got.geojson").read_text() == \
        (tmp_path / "ref.geojson").read_text()
    cent_ref = _mask_ids(jout.polygons_to_centroids(feats_ref))
    cent = _mask_ids(pout.polygons_to_centroids(feats))
    assert cent == cent_ref


def _features(n=400, seed=0):
    """Cell features with near-duplicate centroids (tile overlaps)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 500, (n, 2))
    dup = base[rng.integers(0, n, n // 2)] + rng.normal(0, 3, (n // 2, 2))
    pts = np.concatenate([base, dup])
    sizes = rng.uniform(20, 200, len(pts))
    return [{"id": str(i), "properties": {"measurements": [
        {"name": "area", "value": float(s)},
        {"name": "perimeter", "value": 1.0},
        {"name": "centroidX", "value": float(p[0])},
        {"name": "centroidY", "value": float(p[1])}],
        "classification": {"name": LABELS[i % 4]}}}
        for i, (p, s) in enumerate(zip(pts, sizes))]


@pytest.mark.parametrize("seed", [0, 1])
def test_deduplicate_keeps_same_set(seed):
    feats = _features(seed=seed)
    ref = [f["id"] for f in jgeom.deduplicate(feats)]
    got = [f["id"] for f in pgeom.deduplicate(feats)]
    assert got == ref and len(got) < len(feats)


def _slide(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (1500, 2100, 3),
                                            dtype=np.uint8)
    path = tmp_path / "s.npy"
    np.save(path, arr)
    return str(path)


@pytest.mark.parametrize("mpp,tile,overlap", [(0.5, 256, 64),
                                              (0.4, 512, 64),
                                              (0.25, 300, 32)])
def test_slide_loader_full_grid(tmp_path, monkeypatch, mpp, tile, overlap):
    monkeypatch.setenv("WSI_READER", "array")
    path = _slide(tmp_path)
    kw = dict(slide_path=path, train_mpp=0.5, tile_size=tile,
              overlap=overlap, mpp_override=mpp)
    ref = jload.SlideLoader(**kw).open()
    got = pload.SlideLoader(**kw).open()
    assert got.coords == ref.coords and len(got.coords) > 0
    assert (got.level, got.ts, got.resize_factor) == \
        (ref.level, ref.ts, ref.resize_factor)


def _roi_rings():
    return [np.array([[100, 100], [900, 150], [700, 800], [150, 600]]),
            np.array([[1200, 200], [1900, 200], [1900, 1300],
                      [1200, 1300]])]


def test_slide_loader_roi_grid(tmp_path, monkeypatch):
    monkeypatch.setenv("WSI_READER", "array")
    path = _slide(tmp_path)
    rings = _roi_rings()
    kw = dict(slide_path=path, train_mpp=0.5, tile_size=512, overlap=64,
              mpp_override=0.4)
    ref = jload.SlideLoader(
        roi_tree=jgeom.STRtree([jgeom.Polygon(r) for r in rings]), **kw
    ).open()
    got = pload.SlideLoader(
        roi_tree=pgeom.STRtree([pgeom.Polygon(r) for r in rings]), **kw
    ).open()
    assert got.coords == ref.coords and len(got.coords) > 0
    assert got.filtered_coords() == ref.filtered_coords()


def test_slide_loader_streams_resized_tiles(tmp_path, monkeypatch):
    """Tiles read at 0.4 µm/px and resized to 0.5: the same coordinates
    and sizes as the JAX loader, pixels within 1 grey level of cv2."""
    monkeypatch.setenv("WSI_READER", "array")
    path = _slide(tmp_path)
    kw = dict(slide_path=path, train_mpp=0.5, tile_size=256, overlap=32,
              mpp_override=0.4)
    ref = {c: t for t, c, _ in jload.SlideLoader(**kw).open().stream()}
    got = {c: t for t, c, _ in pload.SlideLoader(**kw).open().stream()}
    assert got.keys() == ref.keys()
    for c, t in got.items():
        assert t.shape == ref[c].shape == (256, 256, 3)
        assert np.abs(t.astype(int) - ref[c].astype(int)).max() <= 1


@pytest.mark.parametrize("src,dst", [((1280, 1280), (1024, 1024)),
                                     ((320, 320), (256, 256)),
                                     ((100, 77), (130, 91)),
                                     ((640, 640), (1024, 1024))])
def test_resize_matches_cv2(src, dst):
    img = np.random.default_rng(0).integers(0, 256, (*src, 3),
                                            dtype=np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = pload.resize_linear_u8(img, dst[1], dst[0])
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_filter_tile_matches():
    rng = np.random.default_rng(0)
    slide, _ = jarr.synthetic_wsi(width=1024, height=512, n_cells=60,
                                  seed=2)
    tiles = [slide._level0[:256, i:i + 256] for i in range(0, 1024, 256)]
    tiles += [np.full((128, 128, 3), 255, np.uint8),
              rng.integers(0, 256, (128, 128, 3), dtype=np.uint8),
              np.zeros((64, 64, 3), np.uint8)]
    ref = [jfilt.filter_tile(t) for t in tiles]
    assert [pfilt.filter_tile(t) for t in tiles] == ref
    assert any(ref) and not all(ref)


def _polygons(seed=0, n=60):
    rng = np.random.default_rng(seed)
    rings = []
    for _ in range(n):
        c = rng.uniform(0, 1000, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        r = rng.uniform(5, 60, 7)
        rings.append(c + np.stack([r * np.cos(ang), r * np.sin(ang)], 1))
    return rings


def test_strtree_queries_match():
    rings = _polygons()
    jt = jgeom.STRtree([jgeom.Polygon(r) for r in rings])
    pt = pgeom.STRtree([pgeom.Polygon(r) for r in rings])
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1000, (3000, 2))
    assert np.array_equal(pt.contains_points(pts), jt.contains_points(pts))
    assert pt.contains_points(pts).any()
    for _ in range(50):
        x, y = rng.uniform(0, 1000, 2)
        w, h = rng.uniform(1, 150, 2)
        bbox = (x, y, x + w, y + h)
        assert sorted(pt.query_bbox(bbox)) == sorted(jt.query_bbox(bbox))
        assert pt.intersects_bbox(bbox) == jt.intersects_bbox(bbox)


def test_polygon_metrics_match():
    for r in _polygons(2, 20):
        hole = r.mean(0) + (r - r.mean(0)) * 0.2
        a, b = jgeom.Polygon(r, holes=[hole]), pgeom.Polygon(r, holes=[hole])
        assert (a.area, a.length, a.centroid, a.bounds, a.is_valid) == \
            (b.area, b.length, b.centroid, b.bounds, b.is_valid)


@pytest.mark.parametrize("ring", [
    [[0, 0], [10, 10], [10, 0], [0, 10]],                # bow-tie
    [[0, 0], [20, 0], [20, 20], [5, -5], [0, 20]],       # crossing spike
    [[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]],        # already valid
    [[0, 0], [30, 0], [0, 30], [30, 30], [15, -10]],
])
def test_make_valid_matches(ring):
    ref = jgeom.make_valid(np.array(ring, float))
    got = pgeom.make_valid(np.array(ring, float))
    assert len(got) == len(ref) >= 1
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_roi_loading_matches(tmp_path):
    feats = [{"type": "Feature", "geometry": {
        "type": "Polygon", "coordinates": [r.tolist() + [r[0].tolist()]]},
        "properties": {"classification": {"name": f"R{i % 2}"}}}
        for i, r in enumerate(_roi_rings())]
    feats.append({"type": "Feature", "geometry": {
        "type": "Polygon",
        "coordinates": [[[0, 0], [10, 10], [10, 0], [0, 10], [0, 0]]]},
        "properties": {"classification": {"name": "R1"}}})
    path = tmp_path / "roi.geojson"
    path.write_text(json.dumps({"type": "FeatureCollection",
                                "features": feats}))
    jt, jd = jout.load_roi_polygons(str(path), group_by_class=True)
    pt, pd_ = pout.load_roi_polygons(str(path), group_by_class=True)
    assert jd.keys() == pd_.keys()
    for k in jd:
        assert [p.exterior.tolist() for p in pd_[k]] == \
            [p.exterior.tolist() for p in jd[k]]
    cells = _features(200, 3)
    for c in cells:
        for m in c["properties"]["measurements"]:
            if m["name"].startswith("centroid"):
                m["value"] *= 3
    assert [c["id"] for c in pout.filter_cells_by_tree(cells, pt)] == \
        [c["id"] for c in jout.filter_cells_by_tree(cells, jt)]
    got = pout.map_cells_to_roi_classes(cells, pd_, ["R1", "nope"])
    ref = jout.map_cells_to_roi_classes(cells, jd, ["R1", "nope"])
    assert {k: [c["id"] for c in v] for k, v in got.items()} == \
        {k: [c["id"] for c in v] for k, v in ref.items()}


def test_densities_csv_text_matches(tmp_path):
    cells = _features(300, 4)
    ref = jout.calculate_cellular_densities(cells, 4.0e6, 1.0e5, 0.5, 0.5,
                                            LABELS)
    got = pout.calculate_cellular_densities(cells, 4.0e6, 1.0e5, 0.5, 0.5,
                                            LABELS)
    ref.to_csv(tmp_path / "ref.csv", index=False)
    pout.write_densities_csv(got, tmp_path / "got.csv")
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "ref.csv").read_text()
    # per ROI class, one region of zero area (densities 0 → "0.0")
    by_roi = {"A": cells[:100], "B": cells[100:], "C": []}
    areas = {"A": 1.0e6, "B": 2.0e6, "C": 0.0}
    ref = jout.calculate_cellular_densities(by_roi, areas, {"A": 1e4},
                                            0.25, 0.25, LABELS)
    got = pout.calculate_cellular_densities(by_roi, areas, {"A": 1e4},
                                            0.25, 0.25, LABELS)
    ref.to_csv(tmp_path / "ref2.csv", index=False)
    pout.write_densities_csv(got, tmp_path / "got2.csv")
    assert (tmp_path / "got2.csv").read_text() == \
        (tmp_path / "ref2.csv").read_text()
    assert pd.read_csv(tmp_path / "got2.csv")["count"].sum() == len(cells)


def test_spatialdata_store_matches(tile_cells, tmp_path):
    """Every file of the zarr store byte for byte, with the same
    metadata and cell ids."""
    (_, _), (got, _) = tile_cells
    feats = [pout.to_geojson_polygon(c) for c in got]
    rows = pout.calculate_cellular_densities(feats, 4.0e4, 0.0, 0.5, 0.5,
                                             LABELS)
    meta = {"slide": "s.npy", "mpp": (0.5, 0.5), "n_cells": len(feats)}
    jout.create_spatialdata_output(tmp_path / "ref.zarr", feats, None, None,
                                   None, pd.DataFrame(rows), meta)
    pout.create_spatialdata_output(tmp_path / "got.zarr", feats, None, None,
                                   None, rows, meta)
    ref_files = sorted(p.relative_to(tmp_path / "ref.zarr")
                       for p in (tmp_path / "ref.zarr").rglob("*")
                       if p.is_file())
    got_files = sorted(p.relative_to(tmp_path / "got.zarr")
                       for p in (tmp_path / "got.zarr").rglob("*")
                       if p.is_file())
    assert got_files == ref_files and len(got_files) > 20
    for f in ref_files:
        assert (tmp_path / "got.zarr" / f).read_bytes() == \
            (tmp_path / "ref.zarr" / f).read_bytes(), f


def test_colormap_matches():
    assert ppost.get_colormap() == jpost.get_colormap()


CONFIGS = [
    {"path": "/w/tiny.npz", "mpp": 0.5, "cell_types": list("ABCD")},
    {"path": "/w/a b.npz", "mpp": 0.25, "url": None,
     "hf": {"repo_id": "classpose/classpose", "filename": "conic.pt"},
     "cell_types": ["Plasma cell", "Other: x", "'q'", "1.5", "yes", "#n"]},
    {"path": "m.npz", "mpp": 1, "hf": None, "cell_types": ["a"]},
    {"path": "/w/m.npz", "mpp": 1e-7, "url": "https://example.org/m.npz",
     "cell_types": ["Tumor", "Stroma"]},
]


@pytest.mark.parametrize("flow", [False, None, True])
@pytest.mark.parametrize("config", CONFIGS)
def test_yaml_config_matches(tmp_path, config, flow):
    text = yaml.safe_dump(config, default_flow_style=flow)
    assert pcfg.parse_yaml(text) == yaml.safe_load(text)
    path = tmp_path / "c.yaml"
    path.write_text(text)
    ref = jcfg.ModelConfig.load_from_yaml(str(path))
    got = pcfg.ModelConfig.load_from_yaml(str(path))
    assert (got.path, got.mpp, got.url, got.cell_types) == \
        (ref.path, ref.mpp, ref.url, ref.cell_types)
    assert (got.hf is None) == (ref.hf is None)
    if ref.hf is not None:
        assert (got.hf.repo_id, got.hf.filename) == \
            (ref.hf.repo_id, ref.hf.filename)


def test_builtin_configs_match():
    assert pcfg.DEFAULT_MODEL_CONFIGS == jcfg.DEFAULT_MODEL_CONFIGS
    for name in jcfg.DEFAULT_MODEL_CONFIGS:
        a = pcfg.resolve_model_config(name)
        b = jcfg.resolve_model_config(name)
        assert (a.path, a.mpp, a.cell_types, a.hf.filename) == \
            (b.path, b.mpp, b.cell_types, b.hf.filename)


def test_download_branches(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(pcfg, "download_if_unavailable",
                        lambda path, url: calls.append((path, url)))
    cfg = pcfg.ModelConfig(path=str(tmp_path / "m.npz"), mpp=0.5,
                           cell_types=["a"], url="https://e.org/m.npz")
    cfg.download_if_necessary()
    assert calls == [(cfg.path, "https://e.org/m.npz")]
    with pytest.raises(FileNotFoundError, match="no download"):
        pcfg.ModelConfig(path=str(tmp_path / "x.npz"), mpp=0.5,
                         cell_types=["a"]).download_if_necessary()


def test_synthetic_slide_matches():
    """Same ground truth for a seed; pixels equal away from the cells'
    anti-aliased edges."""
    kw = dict(width=512, height=384, n_cells=40, n_classes=3, seed=5,
              mpp=0.5)
    js, jgt = jarr.synthetic_wsi(**kw)
    ps, pgt = parr.synthetic_wsi(**kw)
    assert pgt == jgt and len(pgt) >= 20
    d = np.abs(ps._level0.astype(int) - js._level0.astype(int))
    assert (d.max(-1) <= 2).mean() > 0.97
    reg = ps.read_region((100, 50), 1, (64, 32))
    assert reg.shape == (32, 64, 4) and reg.dtype == np.uint8
    assert np.array_equal(reg[..., :3], ps._levels[1][25:57, 50:114])
    # past the slide's edge too: the same RGBA as the JAX reader's
    ref_slide = jarr.ArraySlide(ps._level0)
    for loc in ((100, 50), (480, 360), (-16, -8)):
        assert np.array_equal(
            ps.read_region(loc, 1, (64, 32)),
            np.asarray(ref_slide.read_region(loc, 1, (64, 32))))
