"""The whole WSI pipeline on a TIFF slide: JAX ``pipeline.predict_wsi.main``
with ``WSI_READER=tiff`` against the port's ``main`` with ``WSI_READER``
unset (its default reader, the port's ``TiffSlide``), on the same
1100 × 900 synthetic slide written by the JAX writer as a tiled JPEG
pyramid (``tile=256``, MPP 0.4 in its description, which both runs read:
no ``--mpp``) and the same tiny checkpoint as
``tests/test_torch_pipeline.py``.

The two readers decode the tiles to the same pixels (libjpeg in PIL for
JAX, the port's codec here), so the comparison is the one of the
``.npy`` test: equal tiles, cell counts within 0.5%, ≥ 99% of the port's
cells within 1 px of a JAX cell with the same class. The same holds on
that slide as an Aperio JPEG 2000 pyramid (compression 33005, 9/7 tiles
with the ICT, written by ``tests/golden/regenerate_j2k.py``'s writer):
OpenJPEG in PIL for JAX, the port's decoder here."""

import os

import numpy as np
import pytest
from scipy.spatial import cKDTree

from classpose_tpu.io.array_reader import synthetic_wsi
from classpose_tpu.io.tiff_writer import write_tiled_tiff
from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.pipeline.predict_wsi import main as jax_main
from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
from golden.regenerate_j2k import write_j2k_tiff
from test_torch_pipeline import CFG, LABELS, _args, _centroids
from golden.jax_native import jax_native_geometry  # noqa: F401


def _tiff_args(tmp, out, device):
    args = _args(tmp, out, device)
    args.slide_path = str(tmp / "slide.svs")
    args.mpp = None
    return args


def _run(reader, fn, *args):
    old = os.environ.pop("WSI_READER", None)
    if reader is not None:
        os.environ["WSI_READER"] = reader
    try:
        return fn(*args)
    finally:
        os.environ.pop("WSI_READER", None)
        if old is not None:
            os.environ["WSI_READER"] = old


def _runs(tmp, write, region=None):
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    level0 = slide._level0
    if region is not None:
        level0 = np.ascontiguousarray(level0[:region[0], :region[1]])
    write(tmp / "slide.svs", level0)
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    ref = _run("tiff", jax_main, _tiff_args(tmp, tmp / "jax", None))
    got = _run(None, port_main, _tiff_args(tmp, tmp / "port", "cpu"))
    return tmp, ref, got


# the JPEG 2000 run reads the slide's top-left 700 × 600: 4 tiles
J2K_REGION = (600, 700)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("wsi_tiff"),
                 lambda path, img: write_tiled_tiff(path, img, tile=256,
                                                    mpp=0.4))


@pytest.fixture(scope="module")
def runs_j2k(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("wsi_j2k"),
                 lambda path, img: write_j2k_tiff(
                     path, img, tile=256, mpp=0.4, n_levels=2,
                     irreversible=True, mct=1, quality_layers=[20]),
                 region=J2K_REGION)


def _same_tiles_and_cells(runs, n_tiles, min_cells):
    _, ref, got = runs
    assert got["n_tiles"] == ref["n_tiles"] == n_tiles
    assert ref["n_cells"] >= min_cells
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]


def _centroids_and_classes_match(runs):
    tmp, _, _ = runs
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= 0.99


def test_tiff_slide_same_tiles_and_cells(runs):
    _same_tiles_and_cells(runs, 12, 100)


def test_tiff_slide_centroids_and_classes_match(runs):
    _centroids_and_classes_match(runs)


def test_j2k_slide_same_tiles_and_cells(runs_j2k):
    _same_tiles_and_cells(runs_j2k, 4, 20)


def test_j2k_slide_centroids_and_classes_match(runs_j2k):
    _centroids_and_classes_match(runs_j2k)


def test_tiff_slide_reads_its_mpp(runs):
    """Without ``--mpp`` both runs take 0.4 µm/px from the description
    (level 0, resized by 0.8 to the model's 0.5: the 12 tiles above)."""
    from classpose_tpu.io.tiff_reader import TiffSlide as JaxTiffSlide
    from classpose_tpu.utils import get_slide_resolution as jax_resolution
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.utils import get_slide_resolution

    tmp, _, _ = runs
    path = str(tmp / "slide.svs")
    assert get_slide_resolution(TiffSlide(path)) == \
        jax_resolution(JaxTiffSlide(path)) == (0.4, 0.4)
