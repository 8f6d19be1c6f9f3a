"""The port's ``classpose-predict-wsi`` against the JAX package's: the
same argparse surface (the QuPath contract), the flags that wait and the
device lists that name no card of the machine raising before any slide
is opened, and ``get_device`` never falling back to the CPU."""

import json

import numpy as np
import pytest
import torch

from classpose_tpu.entrypoints.predict_wsi import build_parser as jax_parser
from classpose_tpu_torch import utils as port_utils
from classpose_tpu_torch.entrypoints.predict_wsi import (
    build_parser,
    main_with_args,
)
from classpose_tpu_torch.utils import get_device, get_devices
from test_qupath_contract import REFERENCE_FLAGS
from golden.jax_native import jax_native_geometry  # noqa: F401


def _options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings}


def test_parser_has_every_jax_option():
    ours, ref = _options(build_parser()), _options(jax_parser())
    assert ours.keys() == ref.keys()
    for dest, a in ref.items():
        b = ours[dest]
        assert b.option_strings == a.option_strings, dest
        assert (b.default, b.choices, b.nargs, b.required, type(b)) == \
            (a.default, a.choices, a.nargs, a.required, type(a)), dest


def test_parser_has_qupath_flags():
    flags = {o for a in build_parser()._actions for o in a.option_strings}
    assert REFERENCE_FLAGS <= flags


@pytest.fixture
def setup(tmp_path, monkeypatch):
    """A YAML config on an .npz path that does not exist and a slide
    path that does not exist: anything that reached for either would
    raise FileNotFoundError (or fail to load), not NotImplementedError."""
    monkeypatch.setenv("WSI_READER", "array")
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"path: {tmp_path}/missing.npz\nmpp: 0.5\n"
                   "cell_types: [A, B]\n")
    base = ["--model_config", str(cfg), "--slide_path",
            str(tmp_path / "missing.npy"), "--output_folder",
            str(tmp_path / "out"), "--device", "cpu"]
    return tmp_path, base


def _cards(monkeypatch, count: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("extra,count,match", [
    # the GrandQC flags no longer wait (tests/test_torch_grandqc_pipeline.py)
    # and several cards run (tests/test_torch_multicard.py): a list naming
    # a card the machine lacks, a card twice or a second CPU is refused
    pytest.param(["--device", "cuda:0,1"], 1, "has 1",
                 id="extra2-multi-card"),
    pytest.param(["--device", "gpu:0,1,2"], 2, "has 2",
                 id="extra3-multi-card"),
    pytest.param(["--device", "cuda:1,1"], 2, "twice", id="repeated-card"),
    pytest.param(["--device", "cpu:0,1"], 2, "one CPU", id="several-cpus"),
])
def test_waiting_flags_raise_before_slide(setup, monkeypatch, extra, count,
                                          match):
    tmp_path, base = setup
    _cards(monkeypatch, count)
    with pytest.raises(ValueError, match=match):
        main_with_args(base + extra)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("spec", ["cuda:0,1", "gpu:1,0", "cuda"])
def test_card_list_is_not_refused(setup, monkeypatch, spec):
    """A list of cards the machine has passes the checks: the run goes on
    to the fixture's missing weights."""
    _, base = setup
    _cards(monkeypatch, 2)
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        main_with_args(base + ["--device", spec])


@pytest.mark.parametrize("reader", ["tiff", "czi", "czi-zeiss",
                                    "openslide"])
def test_other_readers_raise(setup, monkeypatch, reader):
    """No reader is refused any more: the TIFF reader (``tiff`` and the
    default ``openslide``) and the CZI reader (``czi``, ``czi-zeiss``) let
    the run go on to the fixture's missing weights, before any slide is
    read."""
    tmp_path, base = setup
    monkeypatch.setenv("WSI_READER", reader)
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        main_with_args(base)
    assert not (tmp_path / "out").exists()


def test_unset_reader_raises(setup, monkeypatch):
    """Unset, ``WSI_READER`` selects the TIFF reader, as the JAX package
    does where OpenSlide is not installed: nothing refuses the run before
    the fixture's missing weights."""
    _, base = setup
    monkeypatch.delenv("WSI_READER")
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        main_with_args(base)


def test_get_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda", None, "", "gpu", "cuda:0", "CUDA"):
        with pytest.raises(RuntimeError, match="no"):
            get_device(spec)


def test_get_device_parses(monkeypatch):
    assert get_device("cpu") == torch.device("cpu")
    _cards(monkeypatch, 2)
    assert get_device(None) == torch.device("cuda", 0)
    assert get_device("gpu") == torch.device("cuda", 0)
    assert get_device("cuda:1") == torch.device("cuda", 1)
    for bad in ("tpu", "tpu:0,1", "npu"):
        with pytest.raises(ValueError):
            get_device(bad)
    # a list is its first card to the single-card entry points
    assert get_device("cuda:1,0") == torch.device("cuda", 1)
    assert get_devices("cuda:0,1") == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]


def test_download_refuses_plain_http(tmp_path):
    with pytest.raises(ValueError, match="insecure"):
        port_utils.download_if_unavailable(str(tmp_path / "x"),
                                           "http://example.org/x")


def test_geojson_filenames_match():
    from classpose_tpu.utils import get_geojson_output_filename as jax_name

    for kind in ("cell_contours", "cell_centroids", "tissue_contours",
                 "artefact_contours", "roi"):
        assert port_utils.get_geojson_output_filename(kind, "S") == \
            jax_name(kind, "S")
    with pytest.raises(ValueError):
        port_utils.get_geojson_output_filename("nope", "S")


def test_slide_resolution_matches():
    from classpose_tpu.utils import get_slide_resolution as jax_res

    for props in ({"openslide.mpp-x": "0.25", "openslide.mpp-y": "0.26"},
                  {"mpp": "0.5"},
                  {"tiff.XResolution": "40000", "tiff.ResolutionUnit":
                   "centimeter"},
                  {"tiff.XResolution": "100000", "tiff.YResolution":
                   "50000"},
                  {"tiff.XResolution": "bad"}, {}):
        slide = type("S", (), {"properties": props})()
        assert port_utils.get_slide_resolution(slide) == jax_res(slide)


def test_cli_runs_on_cpu_and_writes_profile(tmp_path, monkeypatch):
    """The CLI on the CPU at a tiny size, two slides on one model, with a
    torch.profiler trace."""
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.nn.convert import save_params
    from classpose_tpu_torch.nn.synthetic import perturbed_structured_params
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig

    monkeypatch.setenv("WSI_READER", "array")
    slide, _ = synthetic_wsi(width=640, height=384, n_cells=20, seed=1,
                             mpp=0.5)
    for name in ("a", "b"):
        np.save(tmp_path / f"{name}.npy", slide._level0)
    cfg = ClassTransformerConfig(n_cell_classes=3, ps=4, embed_dim=64,
                                 depth=1, num_heads=4, neck_dim=64, bsize=64)
    save_params(perturbed_structured_params(cfg), str(tmp_path / "m.npz"),
                cfg)
    (tmp_path / "c.yaml").write_text(
        f"path: {tmp_path}/m.npz\nmpp: 0.5\ncell_types:\n- X\n- Y\n- Z\n")
    res = main_with_args([
        "--model_config", str(tmp_path / "c.yaml"), "--slide_path",
        str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
        "--output_folder", str(tmp_path / "out"), "--device", "cpu",
        "--precision", "fp32", "--tile_size", "256", "--mpp", "0.5",
        "--profile", str(tmp_path / "trace")])
    assert len(res) == 2 and res[0]["n_tiles"] == res[1]["n_tiles"] == 3
    assert res[0]["n_cells"] == res[1]["n_cells"] > 0
    assert set(res[0]["stage_seconds"]) == {"stream", "drain", "batch",
                                            "host_post", "dedup", "export"}
    for name in ("a", "b"):
        assert (tmp_path / "out" / f"{name}_cell_contours.geojson").exists()
        assert (tmp_path / "out" / f"{name}_cell_centroids.geojson").exists()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    # the second slide's profile: the reader, inference and polygon
    # threads' spans are in the trace (every thread is profiled), and
    # spans.json holds their totals
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    ranges = {e["name"] for e in trace["traceEvents"]}
    assert {"classpose.wsi.read", "classpose.batch.finish",
            "classpose.wsi.post", "classpose.wsi.export"} <= ranges
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans["wsi.read"]["count"] == spans["wsi.post"]["count"] == 3
    assert spans["batch.finish"]["count"] >= 1
    assert spans["batch.finish"]["seconds"] > 0
