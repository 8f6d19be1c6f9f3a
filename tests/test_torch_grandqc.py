"""The port's GrandQC modules against the JAX package's, on the CPU.

- the UNet++ and its encoder: the same seeded weights (an smp state dict
  in the published layout) through the JAX nets and the port's, logits to
  an absolute 1e-4 and argmax in ≥ 99.9% of pixels, with the weights
  carried both ways (JAX tree → ``state_dict_from_jax_grandqc``, and the
  smp state dict → ``load_state_dict``);
- the converter: the port's ``.npz`` equals the JAX converter's key for
  key and value for value, and both refuse the same checkpoints;
- the region tracer against ``cv2.findContours(RETR_CCOMP,
  CHAIN_APPROX_SIMPLE)`` vertex for vertex with the hierarchy;
- ``INTER_AREA`` / ``INTER_NEAREST`` resizes and the JPEG simulation
  bitwise against cv2;
- the patch grid, the component filter, the tissue and artefact stages
  and ``intersection_area`` against the JAX functions.

Flax ``init`` of the full UNet++ takes about a minute on the CPU, so the
JAX converter runs with ``UnetPlusPlus.init`` returning a zero tree of
the shapes ``jax.eval_shape`` gives: a full checkpoint overwrites every
leaf, so the result is the same.
"""

import numpy as np
import pytest
import torch
from golden.jax_native import jax_native_geometry  # noqa: F401

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from classpose_tpu.grandqc import helpers as jh  # noqa: E402
from classpose_tpu.grandqc import nets as jnets  # noqa: E402
from classpose_tpu.grandqc.convert import (  # noqa: E402
    convert_grandqc_checkpoint as jax_convert,
)
from classpose_tpu.io.array_reader import ArraySlide as JaxSlide  # noqa
from classpose_tpu.nn.convert import (  # noqa: E402
    flatten_params,
    save_params,
    unflatten_params,
)
from classpose_tpu_torch.geometry import Polygon  # noqa: E402
from classpose_tpu_torch.geometry.contours import (  # noqa: E402
    contour_area,
    find_contours_ccomp,
)
from classpose_tpu_torch.grandqc import helpers as ph  # noqa: E402
from classpose_tpu_torch.grandqc.convert import (  # noqa: E402
    convert_grandqc_checkpoint,
    grandqc_params_to_jax,
    load_grandqc_npz,
    save_grandqc_npz,
    state_dict_from_jax_grandqc,
)
from classpose_tpu_torch.grandqc.nets import (  # noqa: E402
    UnetPlusPlus,
    UnetPlusPlusConfig,
)
from classpose_tpu_torch.io.array_reader import ArraySlide  # noqa: E402
from classpose_tpu_torch.nn.manifest import grandqc_manifest  # noqa: E402
from classpose_tpu_torch.transforms import cvlite  # noqa: E402

ATOL = 1e-4  # logits, fp32 on the CPU (measured ≤ 1e-5 at these sizes)


def smp_state_dict(classes: int, seed: int) -> dict[str, np.ndarray]:
    """Seeded random weights over every key of the published manifest
    (``num_batches_tracked`` included): He-scaled convs, BatchNorm with
    positive variances, so activations stay finite through the net."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in grandqc_manifest(classes).items():
        if k.endswith("num_batches_tracked"):
            v = np.array(100, np.int64)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "bias")):
            v = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 1:
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        sd[k] = v if v.dtype == np.int64 else v.astype(np.float32)
    return sd


_TEMPLATES: dict = {}


@pytest.fixture(scope="module")
def fast_jax_init():
    """``UnetPlusPlus.init`` → zeros of the shapes ``jax.eval_shape``
    gives (computed once per class count)."""
    orig = jnets.UnetPlusPlus.init

    def init(self, rng, *xs):
        key = self.cfg.classes
        if key not in _TEMPLATES:
            _TEMPLATES[key] = jax.eval_shape(
                lambda r, *a: orig(self, r, *a), rng, *xs)
        return jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), _TEMPLATES[key])

    mp = pytest.MonkeyPatch()
    mp.setattr(jnets.UnetPlusPlus, "init", init)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def art8(fast_jax_init):
    """The 8-class checkpoint, and the JAX converter's params of it."""
    sd = smp_state_dict(8, seed=8)
    params, frac = jax_convert(sd, classes=8, strict=True)
    return sd, params, frac


def _drop_counters(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def _port_net(sd, classes):
    net = UnetPlusPlus(UnetPlusPlusConfig(classes=classes))
    net.load_state_dict(sd, strict=True)
    return net.eval()


def _jax_logits(tree, classes, x):
    net = jnets.UnetPlusPlus(jnets.UnetPlusPlusConfig(classes=classes))
    return np.asarray(jax.jit(net.apply)(tree, x))


def _assert_logits(ref, got):
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.abs(ref - got).max() <= ATOL, np.abs(ref - got).max()
    assert (ref.argmax(1) == got.argmax(1)).mean() >= 0.999


# ------------------------------------------------------------------ nets

def test_port_net_keys_are_the_published_manifest():
    for classes in (2, 8):
        got = {k: tuple(v.shape) for k, v in UnetPlusPlus(
            UnetPlusPlusConfig(classes=classes)).state_dict().items()}
        assert got == grandqc_manifest(classes, bn_counters=False)


@pytest.mark.parametrize("size", [64, 128])
def test_unetpp_2_classes_via_jax_tree(size):
    """JAX tree (from the port's state dict) → both nets; the port's net
    rebuilt from the tree by ``state_dict_from_jax_grandqc``."""
    sd = _drop_counters(smp_state_dict(2, seed=2))
    flat = grandqc_params_to_jax(sd)
    back = state_dict_from_jax_grandqc(flat)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    x = np.random.default_rng(3).normal(size=(1, 3, size, size)).astype(
        np.float32)
    ref = _jax_logits(unflatten_params(flat), 2, x)
    with torch.no_grad():
        got = _port_net(back, 2)(torch.from_numpy(x)).numpy()
    _assert_logits(ref, got)


@pytest.mark.parametrize("size", [64, 128])
def test_unetpp_8_classes_via_smp_state_dict(art8, size):
    """The smp state dict, counters dropped, into the port's net; the
    JAX converter's tree into the JAX net; and the port's net rebuilt
    from that tree."""
    sd, params, _ = art8
    x = np.random.default_rng(4).normal(size=(1, 3, size, size)).astype(
        np.float32)
    ref = _jax_logits(params, 8, x)
    with torch.no_grad():
        got = _port_net(_drop_counters(sd), 8)(torch.from_numpy(x)).numpy()
        got2 = _port_net(state_dict_from_jax_grandqc(
            flatten_params(params)), 8)(torch.from_numpy(x)).numpy()
    _assert_logits(ref, got)
    np.testing.assert_array_equal(got, got2)


def test_encoder_pyramid_matches_jax(art8):
    sd, params, _ = art8
    x = np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    enc = jnets.EfficientNetB0Encoder()
    ref = jax.jit(enc.apply)({"params": params["params"]["encoder"]}, x)
    net = _port_net(_drop_counters(sd), 8)
    with torch.no_grad():
        got = net.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[1:2]) for g in got] == \
        [(c,) for c in jnets.B0_OUT_CHANNELS]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=0, atol=ATOL)


# ------------------------------------------------------------- converter

def test_converter_writes_the_jax_npz(art8, tmp_path):
    sd, params, frac = art8
    got, got_frac = convert_grandqc_checkpoint(sd, classes=8, strict=True)
    assert got_frac == frac == 1.0
    save_grandqc_npz(got, str(tmp_path / "port.npz"),
                     UnetPlusPlusConfig(classes=8))
    save_params(params, str(tmp_path / "jax.npz"),
                jnets.UnetPlusPlusConfig(classes=8))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    sd2, cfg = load_grandqc_npz(str(tmp_path / "jax.npz"))
    assert cfg == UnetPlusPlusConfig(classes=8)
    assert all(torch.equal(sd2[k], got[k]) for k in got)


def _refusal_cases():
    def drop(prefix):
        return lambda sd: {k: v for k, v in sd.items()
                           if not k.startswith(prefix)}

    def with_extra(key, shape):
        return lambda sd: {**sd, key: np.zeros(shape, np.float32)}

    def reshape(key):
        return lambda sd: {**sd, key: sd[key][:-1]}

    return {
        "decoder_block_missing": (drop("decoder.blocks.x_0_4."), False),
        "encoder_tensor_missing": (drop("encoder.bn1.weight"), False),
        "head_missing": (drop("segmentation_head"), False),
        "shape_mismatch": (reshape("encoder.blocks.2.1.bn2.weight"), False),
        "decoder_shape_mismatch": (
            reshape("decoder.blocks.x_1_2.conv2.1.bias"), False),
        "bias_on_padded_conv": (
            with_extra("encoder.conv_stem.bias", (32,)), False),
        "leftover_strict": (with_extra("aux.weight", (3,)), True),
        "leftover_lenient": (with_extra("aux.weight", (3,)), False),
        "encoder_only": (drop("decoder."), True),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_converter_refusals_match_jax(art8, case):
    edit, strict = _refusal_cases()[case]
    sd = edit(dict(art8[0]))
    if case == "encoder_only":
        sd = {k: v for k, v in sd.items()
              if not k.startswith("segmentation_head")}

    def run(fn):
        try:
            return fn(sd, classes=8, strict=strict), None
        except Exception as e:  # noqa: BLE001 — the type is compared
            return None, type(e)

    (ref, ref_err), (got, got_err) = run(jax_convert), run(
        convert_grandqc_checkpoint)
    assert got_err is ref_err
    if ref_err is None:
        assert got[1] == pytest.approx(ref[1])
        ref_flat = flatten_params(ref[0])
        got_flat = grandqc_params_to_jax(got[0])
        assert got_flat.keys() == ref_flat.keys()
        for k, v in ref_flat.items():
            if k.startswith("params/encoder/"):
                assert np.array_equal(got_flat[k], v), k
    if case == "encoder_only":
        assert ref[1] < 1.0
    elif case == "leftover_lenient":
        assert ref[1] == 1.0
    else:
        assert ref_err is not None


# ---------------------------------------------------------------- tracer

def _masks():
    out = {}
    m = np.zeros((40, 40), np.uint8)
    m[4:36, 4:36] = 1
    m[10:30, 10:30] = 0
    m[15:25, 15:25] = 1          # an island in the hole
    m[18:22, 18:22] = 0          # a hole in the island
    out["nested"] = m
    m = np.zeros((12, 12), np.uint8)
    m[2, 2] = m[3, 3] = m[4, 4] = m[4, 2] = 1  # touching diagonals
    m[8, 8] = 1                  # one pixel
    out["diagonals"] = m
    m = np.zeros((20, 30), np.uint8)
    m[:, :5] = 1                 # border contact on three sides
    m[0, :] = 1
    m[5:15, 20:30] = 1
    m[8:12, 24:27] = 0           # a hole at the right edge region
    out["border"] = m
    out["full"] = np.ones((7, 9), np.uint8)
    out["empty"] = np.zeros((7, 9), np.uint8)
    m = np.zeros((30, 30), np.uint8)
    m[2:28, 2:28] = 1
    for y in range(4, 26, 4):    # many holes, some 1 px, one wall apart
        for x in range(4, 26, 3):
            m[y, x] = 0
    m[10:12, 10:13] = 0
    out["many_holes"] = m
    rng = np.random.default_rng(0)
    from scipy import ndimage
    for s in range(3):
        out[f"noise{s}"] = (rng.random((37, 53)) < 0.5).astype(np.uint8)
        out[f"blobs{s}"] = (ndimage.gaussian_filter(
            rng.random((260, 320)), 1.5) > 0.5).astype(np.uint8)
    return out


@pytest.mark.parametrize("name", list(_masks()))
def test_ccomp_tracer_matches_cv2(name):
    mask = _masks()[name]
    ref, hier = cv2.findContours(mask, cv2.RETR_CCOMP,
                                 cv2.CHAIN_APPROX_SIMPLE)
    got, got_hier = find_contours_ccomp(mask)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r[:, 0])
        assert contour_area(g) == cv2.contourArea(r)
    if ref:
        np.testing.assert_array_equal(got_hier, hier[0])
    if name.startswith("blobs"):
        assert len(ref) > 127  # more borders than cv2's 7-bit marks


def test_ccomp_tracer_leaves_cell_contours_alone():
    """The cell path's tracer is untouched: ``contours_batch`` on a label
    image gives cv2's EXTERNAL contour of each instance."""
    from classpose_tpu_torch.pipeline.postprocess import contours_batch

    lab = np.zeros((20, 20), np.int32)
    lab[2:8, 2:8] = 1
    lab[4:6, 4:6] = 0
    lab[10:18, 11:19] = 2
    pts, offs, ids, _ = contours_batch(lab)
    for k, i in enumerate(ids):
        ref = cv2.findContours((lab == i).astype(np.uint8),
                               cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)[0][0][:, 0]
        np.testing.assert_array_equal(pts[offs[k]:offs[k + 1]], ref)


@pytest.mark.parametrize("min_area", [0.0, 10.0])
def test_contours_with_holes_matches_jax(min_area):
    mask = _masks()["blobs0"]
    ref = jh.contours_with_holes(mask, min_area_px=min_area)
    got = ph.contours_with_holes(mask, min_area_px=min_area)
    assert len(got) == len(ref)
    for (re, rh), (ge, gh) in zip(ref, got):
        np.testing.assert_array_equal(ge, re)
        assert len(gh) == len(rh)
        for a, b in zip(gh, rh):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- resizes

@pytest.mark.parametrize("src,dst", [
    ((768, 768), (245, 245)),      # chip slide, tissue (level 3)
    ((3072, 3072), (2457, 2457)),  # chip slide, artefact (level 1)
    ((112, 137), (36, 44)),        # test slide, tissue
    ((450, 550), (360, 440)),      # test slide, artefact
    ((1024, 2048), (512, 1024)),   # integer factor 2 (vector path)
    ((900, 1200), (300, 400)),     # integer factor 3
    ((100, 77), (13, 9)),
    ((768, 768), (153, 153)),      # chip slide read at 0.25 µm/px, tissue
    ((301, 517), (301, 517)),      # identity (the chip's MPP-1 thumbnail)
    ((37, 53), (101, 77)),         # enlarging (a slide coarser than MPP 1)
    ((50, 60), (71, 45)),          # one side grows, the other shrinks
    ((13, 9), (14, 10)),
])
def test_resize_area_bitwise_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for chan in ((3,), ()):
        img = rng.integers(0, 256, src + chan, dtype=np.uint8)
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(ph.resize_area(img, dst[1], dst[0]),
                                      ref)


@pytest.mark.parametrize("src,dst", [
    ((36, 44), (360, 440)), ((245, 245), (2457, 2457)),
    ((13, 9), (100, 77)), ((50, 50), (50, 50)),
])
def test_resize_nearest_bitwise_cv2(src, dst):
    rng = np.random.default_rng(sum(src))
    m = rng.integers(0, 2, src, dtype=np.uint8)
    ref = cv2.resize(m, dst[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(
        cvlite.resize_nearest(m, dst[1], dst[0]), ref)


def test_thumbnail_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (900, 1100, 3), dtype=np.uint8)
    for mpp_target in (10.0, 1.0):
        ref = jh.extract_slide_thumbnail(JaxSlide(img, mpp=0.4), mpp_target)
        got = ph.extract_slide_thumbnail(ArraySlide(img, mpp=0.4),
                                         mpp_target)
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]


@pytest.mark.parametrize("shape", [(512, 512), (301, 517), (17, 9)])
def test_jpeg_simulation_bitwise_cv2(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    ref = jh.simulate_jpeg_compression(img)
    np.testing.assert_array_equal(ph.simulate_jpeg_compression(img), ref)


# ------------------------------------------------------- grids, filters

def test_patch_grid_and_predict_mask_match_jax():
    img = np.random.default_rng(2).integers(0, 256, (700, 1100, 3),
                                            dtype=np.uint8)
    ref = [(y, x, p.copy()) for y, x, p in jh.iter_patches(img, 512)]
    got = list(ph.iter_patches(img, 512))
    assert [(y, x) for y, x, _ in got] == [(y, x) for y, x, _ in ref]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(got, ref))

    def fn(batch):
        return (batch.mean(-1) > 128).astype(np.int32)

    def keep(y, x, p):
        return x > 0

    for kw in ({}, {"patch_filter": keep, "fill_value": 7,
                    "batch_size": 2}):
        np.testing.assert_array_equal(ph.predict_mask(img, fn, **kw),
                                      jh.predict_mask(img, fn, **kw))


@pytest.mark.parametrize("min_area", [0.0, 50.0, 300.0])
def test_component_filter_matches_jax(min_area):
    from scipy import ndimage

    rng = np.random.default_rng(3)
    mask = ndimage.gaussian_filter(rng.random((90, 120)), 1.2) > 0.52
    np.testing.assert_array_equal(
        ph.filter_components_by_area(mask, min_area, 1.0),
        jh.filter_components_by_area(mask, min_area, 1.0))


# ----------------------------------------------------- the stages, oracles

def _qc_slide():
    """A white slide with a pink tissue ellipse, a dark disc inside it, a
    small speck of tissue apart, and a ring with a hole."""
    H, W = 3072, 4096
    img = np.full((H, W, 3), 245, np.uint8)
    yy, xx = np.mgrid[:H, :W]
    tissue = ((yy - H / 2) ** 2 / (H / 3) ** 2
              + (xx - W / 2) ** 2 / (W / 3) ** 2) <= 1
    img[tissue] = [225, 180, 210]
    img[((yy - H / 2) ** 2 + (xx - W / 2) ** 2) <= (H / 10) ** 2] = 40
    img[100:160, 100:160] = [225, 180, 210]
    r = np.hypot(yy - 400, xx - 3700)
    img[(r < 300) & (r > 120)] = [225, 180, 210]
    return img


def _tissue_oracle(batch):
    return (batch.mean(-1) < 238).astype(np.int32)


def _artefact_oracle(batch):
    out = np.ones(batch.shape[:-1], np.int32)
    out[batch.mean(-1) < 100] = 3
    return out


def _geometry(features):
    return [(f["geometry"]["coordinates"],
             f["properties"]["classification"]["name"]) for f in features]


@pytest.fixture(scope="module")
def qc_runs():
    from classpose_tpu.grandqc import detect_artefacts_wsi as jart
    from classpose_tpu.grandqc import detect_tissue_wsi as jtis
    from classpose_tpu_torch.grandqc import detect_artefacts_wsi as part
    from classpose_tpu_torch.grandqc import detect_tissue_wsi as ptis

    img = _qc_slide()
    out = {}
    for min_area in (0.0, 40000.0):
        out[("tissue", min_area)] = (
            jtis(JaxSlide(img, mpp=0.25), predict_fn=_tissue_oracle,
                 min_area=min_area),
            ptis(ArraySlide(img, mpp=0.25), predict_fn=_tissue_oracle,
                 min_area=min_area))
    out["artefact"] = (
        jart(JaxSlide(img, mpp=0.25), predict_fn=_artefact_oracle,
             tissue_predict_fn=_tissue_oracle),
        part(ArraySlide(img, mpp=0.25), predict_fn=_artefact_oracle,
             tissue_predict_fn=_tissue_oracle))
    return out


@pytest.mark.parametrize("min_area", [0.0, 40000.0])
def test_tissue_stage_matches_jax(qc_runs, min_area):
    ref, got = qc_runs[("tissue", min_area)]
    np.testing.assert_array_equal(got["thumb"], ref["thumb"])
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert _geometry(got["geojson"]["features"]) == \
        _geometry(ref["geojson"]["features"])
    assert [p.area for p in got["polygons"]] == \
        [p.area for p in ref["polygons"]]
    assert got["scale_to_level0"] == ref["scale_to_level0"]
    assert len(got["polygons"]) >= (1 if min_area else 2)


def test_artefact_stage_matches_jax(qc_runs):
    ref, got = qc_runs["artefact"]
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["colormap"], ref["colormap"])
    assert _geometry(got["geojson"]["features"]) == \
        _geometry(ref["geojson"]["features"])
    assert len(got["contours"][3]) >= 1


def test_no_tissue_slide():
    from classpose_tpu_torch.grandqc import detect_tissue_wsi

    img = np.full((2048, 2048, 3), 250, np.uint8)
    res = detect_tissue_wsi(ArraySlide(img, mpp=0.25),
                            predict_fn=_tissue_oracle)
    assert not res["mask"].any() and res["polygons"] == []


# ------------------------------------------------------ intersection area

def _square(x, y, s):
    return [(x, y), (x + s, y), (x + s, y + s), (x, y + s)]


def _area_pairs():
    from scipy.spatial import ConvexHull

    sq = _square(0, 0, 100)
    inner = _square(25, 25, 50)
    pairs = {
        "half": (sq, _square(50, 0, 100), None),
        "disjoint": (sq, _square(500, 500, 100), None),
        "contained": (sq, inner, None),
        "identical": (sq, sq, None),
        "concave": ([(0, 0), (100, 0), (100, 40), (40, 40), (40, 100),
                     (0, 100)], inner, None),
        "holed": (sq, inner, [_square(20, 20, 60)]),
        "level0": (_square(0, 0, 100000), _square(50000, 0, 100000), None),
    }
    rng = np.random.default_rng(7)
    for t in range(4):
        p1 = rng.uniform(0, 100, size=(12, 2))
        p2 = rng.uniform(0, 100, size=(12, 2)) + rng.uniform(-40, 40, 2)
        pairs[f"convex{t}"] = (p1[ConvexHull(p1).vertices],
                               p2[ConvexHull(p2).vertices], None)
    return pairs


@pytest.mark.parametrize("name", list(_area_pairs()))
def test_intersection_area_matches_jax(name):
    from classpose_tpu.geometry import Polygon as JPolygon
    from classpose_tpu.geometry import intersection_area as jia
    from classpose_tpu_torch.geometry import intersection_area

    a, b, holes = _area_pairs()[name]
    ref = jia(JPolygon(a, holes=holes), JPolygon(b))
    got = intersection_area(Polygon(a, holes=holes), Polygon(b))
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-9)
