"""``--fast_qc`` in the port against the JAX package: ``eval_batch`` with
``qc_downsample=2`` and ``percentile_subsample=2`` (the host QC of the
JAX package's unfused path: one batched diffusion of the labels at every
other pixel), and the WSI CLI with ``--fast_qc``.

``eval_batch`` runs on 2 × 128² tiles, fp32, niter 40, with the JAX
``perturbed_structured_params`` written as a native ``.npz``; the flow
thresholds include one at which the QC drops most instances. Masks and
classes must be equal: below the QC both packages run the same device
program, and the QC's diffusion is bitwise the JAX stencil."""

import os

import numpy as np
import pytest

from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
from classpose_tpu.nn.convert import save_params
from classpose_tpu.nn.synthetic import perturbed_structured_params
from classpose_tpu.runner import ClassposeModel as JaxModel
from classpose_tpu_torch.runner import ClassposeModel
from test_torch_checkpoints import CELL_CFG
from golden.jax_native import jax_native_geometry  # noqa: F401


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """ripple → (JAX model, port model) on the same ``.npz``."""
    out = {}
    for ripple in (0.5, 2.0):
        cfg = JaxCfg(**CELL_CFG)
        path = str(tmp_path_factory.mktemp("ck") / "ck.npz")
        save_params(perturbed_structured_params(cfg, ripple=ripple, seed=0),
                    path, cfg=cfg)
        out[ripple] = (JaxModel(pretrained_model=path, precision="fp32"),
                       ClassposeModel(pretrained_model=path,
                                      precision="fp32", device="cpu"))
    return out


def _tiles(kind):
    t = np.random.default_rng(1).uniform(0, 255, size=(2, 128, 128, 3))
    return t.astype(np.uint8 if kind == "uint8" else np.float32)


# (ripple, flow_threshold): the QC keeps every instance; drops 10 of 16
# per tile; drops one of 17
CASES = [(0.5, 0.4), (0.5, 0.02), (2.0, 0.4)]


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("ripple,flow_threshold", CASES)
def test_fast_qc_eval_batch_matches_jax(models, kind, ripple,
                                        flow_threshold):
    jax_model, model = models[ripple]
    tiles = _tiles(kind)
    kw = dict(batch_size=8, niter=40, flow_threshold=flow_threshold,
              qc_downsample=2, percentile_subsample=2)
    ref = jax_model.eval_batch(tiles, **kw)
    got = model.eval_batch(tiles, **kw)
    none = model.eval_batch(tiles, **{**kw, "flow_threshold": 0.0})
    for (m_ref, c_ref), (m, c), (m0, _) in zip(ref, got, none):
        assert m.dtype == c.dtype == np.int32
        assert m0.max() >= 10
        np.testing.assert_array_equal(m, m_ref)
        np.testing.assert_array_equal(c, c_ref)
    dropped = sum(int(m0.max()) - int(m.max())
                  for (m, _), (m0, _) in zip(got, none))
    assert (dropped > 0) == (flow_threshold < 0.4 or ripple > 1)


def test_percentile_subsample_on_the_device_path(models):
    """``percentile_subsample=2`` alone keeps the device QC and changes a
    float tile's normalization as the JAX package's does."""
    jax_model, model = models[2.0]
    tiles = _tiles("float")
    kw = dict(batch_size=8, niter=40, percentile_subsample=2)
    for (m_ref, c_ref), (m, c) in zip(jax_model.eval_batch(tiles, **kw),
                                      model.eval_batch(tiles, **kw)):
        np.testing.assert_array_equal(m, m_ref)
        np.testing.assert_array_equal(c, c_ref)


def test_fast_qc_cli_matches_jax(tmp_path):
    """The WSI CLI with ``--fast_qc`` on the CPU against the JAX pipeline
    with ``--fast_qc``, as ``tests/test_torch_pipeline.py`` runs them."""
    from classpose_tpu.io.array_reader import synthetic_wsi
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_entrypoints import assert_same_cells
    from test_torch_pipeline import LABELS, _args

    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    np.save(tmp_path / "slide.npy", slide._level0)
    cfg = JaxCfg(**CELL_CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp_path / "ckpt.npz"), cfg=cfg)
    (tmp_path / "config.yaml").write_text(
        f"path: {tmp_path}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    old = os.environ.get("WSI_READER")
    os.environ["WSI_READER"] = "array"
    try:
        runs = {}
        for name, main, device in (("jax", jax_main, None),
                                   ("port", port_main, "cpu")):
            args = _args(tmp_path, tmp_path / name, device)
            args.fast_qc = True
            runs[name] = main(args)
    finally:
        if old is None:
            os.environ.pop("WSI_READER")
        else:
            os.environ["WSI_READER"] = old
    assert runs["port"]["n_tiles"] == runs["jax"]["n_tiles"] == 12
    assert_same_cells(tmp_path / "port" / "slide_cell_centroids.geojson",
                      tmp_path / "jax" / "slide_cell_centroids.geojson")
