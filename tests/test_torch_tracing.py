"""The port's spans and counters (``classpose_tpu_torch/tracing.py``): a
span costs a flag read without a profile and adds only to its sink;
under a profile it is a ``classpose.<name>`` range and adds to the
registry from any thread; the WSI ``main`` and ``ClassposeModel.eval``
record each stage once per tile, batch or image. Imports nothing of the
JAX package, so it also runs with ``--noconftest``."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from classpose_tpu_torch import tracing


@pytest.fixture(autouse=True)
def empty_registry():
    tracing.reset_profiled()
    yield
    tracing.reset_profiled()


def _ranges(prof) -> dict:
    """name -> [(start_ns, end_ns, thread)] of the profile's classpose
    user annotations."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX) and e.is_user_annotation():
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.start_thread_id()))
    return out


def test_profiler_flag_is_read_on_every_thread():
    """The private flag the spans read: off without a profile, on in any
    thread while one records. A torch that drops or renames it fails
    here instead of recording nothing."""
    import torch.autograd.profiler as ap

    assert ap._is_profiler_enabled is False
    assert not tracing.recording()
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        assert ap._is_profiler_enabled is True
        t = threading.Thread(target=lambda: seen.append(tracing.recording()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen == [True]
    assert ap._is_profiler_enabled is False


def test_span_without_profile_adds_only_to_its_sink(monkeypatch):
    def no_range(*a, **kw):
        raise AssertionError("record_function opened without a profile")

    monkeypatch.setattr(tracing, "record_function", no_range)
    sink: dict = {}
    with tracing.span("a", into=sink):
        with tracing.span("b"):
            pass
    with tracing.span("a", into=sink, args="batch=1"):
        pass
    tracing.add("q", 2.5, into=sink)
    tracing.add("r", 1.0)
    assert set(sink) == {"a", "q"} and sink["a"] >= 0 and sink["q"] == 2.5
    assert tracing.profiled() == {}


def test_main_thread_spans_are_nested_ranges():
    sink: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer", into=sink, args="batch=7"):
            with tracing.span("inner"):
                torch.ones(8).sum()
            with tracing.span("inner"):
                pass
    r = _ranges(prof)
    assert set(r) == {"classpose.outer", "classpose.inner"}
    (o0, o1, _), = r["classpose.outer"]
    assert len(r["classpose.inner"]) == 2
    assert all(o0 <= i0 <= i1 <= o1 for i0, i1, _ in r["classpose.inner"])
    reg = tracing.profiled()
    assert reg["outer"][1] == 1 and reg["inner"][1] == 2
    assert reg["outer"][0] >= reg["inner"][0] > 0
    assert sink == {"outer": reg["outer"][0]}


def test_worker_threads_add_under_the_lock():
    """Many threads, short switch interval: no span, wait or sink update
    is lost (sums of 1.0 are exact)."""
    n_threads, n_spans = 16, 200
    sink: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with tracing.span("w", into=sink):
                    pass
                tracing.add("wait", 1.0, into=sink)

        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    reg = tracing.profiled()
    assert reg["w"][1] == reg["wait"][1] == n_threads * n_spans
    assert reg["wait"][0] == sink["wait"] == float(n_threads * n_spans)
    assert sink["w"] == pytest.approx(reg["w"][0])


def test_add_and_reset():
    tracing.add("q", 3.0)  # no profile: nothing recorded
    assert tracing.profiled() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.add("q", 3.0)
        tracing.add("q", 0.5)
    assert tracing.profiled() == {"q": (3.5, 2)}
    snap = tracing.profiled()
    tracing.reset_profiled()
    assert tracing.profiled() == {} and snap == {"q": (3.5, 2)}


def _tiny_model(tmp_path):
    from classpose_tpu_torch.nn.convert import save_params
    from classpose_tpu_torch.nn.synthetic import perturbed_structured_params
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig

    cfg = ClassTransformerConfig(n_cell_classes=3, ps=4, embed_dim=64,
                                 depth=1, num_heads=4, neck_dim=64, bsize=64)
    path = str(tmp_path / "m.npz")
    save_params(perturbed_structured_params(cfg), path, cfg)
    return path


def test_wsi_main_records_each_stage(tmp_path, monkeypatch):
    """The WSI ``main`` on the CPU under a profile: a read, a resize and a
    polygon job per tile, a queue wait and the three ``eval_batch``
    stages per batch, the net's sublayers, and ``stage_seconds`` built
    from the spans."""
    from classpose_tpu_torch.entrypoints.predict_wsi import build_parser
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.model_configs import ModelConfig
    from classpose_tpu_torch.pipeline.predict_wsi import main

    monkeypatch.setenv("WSI_READER", "array")
    slide, _ = synthetic_wsi(width=700, height=500, n_cells=30, seed=2,
                             mpp=0.45)
    np.save(tmp_path / "s.npy", slide._level0)
    args = build_parser().parse_args([
        "--model_config", "conic", "--slide_path", str(tmp_path / "s.npy"),
        "--output_folder", str(tmp_path / "out"), "--device", "cpu",
        "--precision", "fp32", "--tile_size", "256", "--mpp", "0.45",
        "--tile_batch", "2", "--output_type", "csv", "spatialdata"])
    args.slide_path = str(tmp_path / "s.npy")
    args.model_config = ModelConfig(path=_tiny_model(tmp_path), mpp=0.5,
                                    cell_types=["X", "Y", "Z"])
    with profile(activities=[ProfilerActivity.CPU]):
        res = main(args)
    reg = tracing.profiled()
    tiles, batches = res["n_tiles"], sum(res["batches_per_device"])
    assert tiles == 4 and batches == 2 and res["n_cells"] > 0
    for name in ("wsi.read", "wsi.resize", "wsi.read_wait", "wsi.post",
                 "wsi.post_queue"):
        assert reg[name][1] == tiles, name
    for name in ("wsi.submit", "wsi.batch_queue", "wsi.batch",
                 "batch.program", "batch.readback", "batch.finish"):
        assert reg[name][1] == batches, name
    for name in ("model.normalize", "model.net"):
        assert reg[name][1] == tiles, name
    for name in ("model.blend", "model.flows", "model.masks", "model.qc"):
        assert reg[name][1] == batches, name
    for name in ("wsi.stream", "wsi.drain", "wsi.dedup", "wsi.export",
                 "wsi.export.filter", "wsi.export.geojson",
                 "wsi.export.densities", "wsi.export.spatialdata"):
        assert reg[name][1] == 1, name
    assert reg["net.gelu"][1] == reg["net.norm1"][1] > 0
    st = res["stage_seconds"]
    assert set(st) == {"stream", "drain", "batch", "host_post", "dedup",
                       "export"}
    for key, name in (("stream", "wsi.stream"), ("batch", "wsi.batch"),
                      ("host_post", "wsi.post"), ("export", "wsi.export")):
        assert st[key] == round(reg[name][0], 3), key
    assert reg["wsi.read_wait"][0] + reg["wsi.submit"][0] <= \
        reg["wsi.stream"][0]


def test_eval_records_each_image(tmp_path):
    """``ClassposeModel.eval`` on two images under a profile: each image
    stage once per image, the mask stages inside ``image.masks``."""
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.runner import ClassposeModel

    model = ClassposeModel(pretrained_model=_tiny_model(tmp_path),
                           device="cpu")
    slide, _ = synthetic_wsi(width=96, height=80, n_cells=6, seed=3,
                             mpp=0.5)
    img = slide._level0.astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        masks, _, _, _ = model.eval([img, img[::-1].copy()])
    assert len(masks) == 2 and all(m.max() > 0 for m in masks)
    reg = tracing.profiled()
    for name in ("image", "image.normalize", "image.net", "image.readback",
                 "image.masks", "image.vote", "image.circ",
                 "masks.follow", "masks.labels", "masks.holes"):
        assert reg[name][1] == 2, name
    parts = sum(reg[n][0] for n in ("image.normalize", "image.net",
                                    "image.readback", "image.masks",
                                    "image.vote", "image.circ"))
    assert parts <= reg["image"][0]
    r = _ranges(prof)
    for (i0, i1, _), (m0, m1, _) in zip(sorted(r["classpose.image"]),
                                        sorted(r["classpose.image.masks"])):
        assert i0 <= m0 <= m1 <= i1
