"""The port's JPEG decoder on every process PIL (libjpeg-turbo 3.1) reads,
bit for bit against PIL's ``convert("RGB")``, which is what the JAX
``TiffSlide`` returns for a compression-7 tile:

- the committed goldens (``tests/golden/regenerate_jpeg.py``): progressive
  Huffman (SOF2) with complete and incomplete scripts (libjpeg's block
  smoothing), arithmetic coding (SOF9, SOF10, DAC), CMYK and YCCK,
  sampling factors 3 and 4, lossless (SOF3), each decoded by the port to
  PIL's hash, and PIL still decoding them to it;
- streams PIL writes here: progressive at every subsampling, with
  ``optimize``, restart markers, odd sizes and CMYK;
- lossless streams written here by the goldens' Python encoder
  (predictors 1-7, point transforms, restarts, sampling factors);
- the refusals: every stream PIL refuses, the port refuses with a
  ``ValueError`` that names the process or feature;
- the slice: ``tests/golden/jpeg_region.svs`` (tiles of SOF2, SOF10, SOF9
  and 4:1:1) read by the JAX ``TiffSlide`` and the port's bitwise at every
  level, and JAX ``main`` against the port's ``main`` on it.

PIL is used here only; the port never imports it."""

import hashlib
import io
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from classpose_tpu_torch.io import jpeg
from golden.regenerate_jpeg import image, lossless_jpeg
from golden.jax_native import jax_native_geometry  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
SPEC = json.loads((GOLDEN / "jpeg_golden.json").read_text())


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _sha(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def _same_as_pil(data):
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))


# ------------------------------------------------------------ goldens

@pytest.mark.parametrize("name", sorted(SPEC["streams"]))
def test_golden_stream(name):
    data = (GOLDEN / f"jpeg_{name}.jpg").read_bytes()
    want = SPEC["streams"][name]
    got = jpeg.decode(data)
    assert list(got.shape) == want["shape"]
    assert _sha(got) == want["sha256"]
    assert _sha(_pil_rgb(data)) == want["sha256"]  # PIL still agrees


@pytest.mark.parametrize("name", sorted(SPEC["refused"]))
def test_golden_refusal(name):
    data = (GOLDEN / f"jpeg_refused_{name}.jpg").read_bytes()
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError, match=re.escape(SPEC["refused"][name])):
        jpeg.decode(data)


def test_info_reports_the_frame():
    """``info`` reads any process's frame header and refuses what the
    frame header refuses; a 4-component stream still decodes to RGB."""
    cmyk = (GOLDEN / "jpeg_cmyk_adobe.jpg").read_bytes()
    assert jpeg.info(cmyk) == (37, 45, 4)
    assert jpeg.decode(cmyk).shape == (37, 45, 3)
    for name in ("sof2_pil", "sof9", "sof10", "sof3_p1"):
        h, w, _ = SPEC["streams"][name]["shape"]
        assert jpeg.info((GOLDEN / f"jpeg_{name}.jpg").read_bytes()) == \
            (h, w, 3)
    for name in ("precision_12", "sof11", "dnl_height_0"):  # frame-level
        data = (GOLDEN / f"jpeg_refused_{name}.jpg").read_bytes()
        with pytest.raises(ValueError, match=SPEC["refused"][name]):
            jpeg.info(data)


# ------------------------------------------------- PIL-written streams

def _pil_jpeg(img, **kw):
    mode = "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[2]]
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("size", [(1, 1), (8, 8), (17, 33), (37, 53),
                                  (130, 97)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive_equals_pil(size, subsampling):
    img = image(*size, 3, seed=size[0])
    _same_as_pil(_pil_jpeg(img, quality=85, progressive=True,
                           subsampling=subsampling))


@pytest.mark.parametrize("kw", [
    dict(optimize=True), dict(restart_marker_blocks=3),
    dict(restart_marker_rows=1, optimize=True), dict(quality=100),
    dict(quality=20), dict(keep_rgb=True)], ids=str)
def test_progressive_options_equal_pil(kw):
    img = image(45, 61, 3, seed=3)
    _same_as_pil(_pil_jpeg(img, progressive=True, **kw))


@pytest.mark.parametrize("size", [(9, 7), (40, 33)])
def test_progressive_grey_equals_pil(size):
    _same_as_pil(_pil_jpeg(image(*size, 1, seed=5)[..., 0],
                           progressive=True, quality=75))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("size", [(16, 16), (29, 35)])
def test_cmyk_equals_pil(progressive, size):
    """PIL writes CMYK with an Adobe marker and reads every 4-component
    stream as inverted CMYK, then converts with its own ``cmyk2rgb``."""
    _same_as_pil(_pil_jpeg(image(*size, 4, seed=6), quality=80,
                           progressive=progressive))


def test_missing_huffman_tables_take_the_standard_ones():
    """libjpeg-turbo fills Huffman slots 0 and 1 a stream leaves undefined
    with the Annex K tables (Motion-JPEG frames); PIL's baseline streams
    use those tables, so dropping their DHT segments changes nothing."""
    data = _pil_jpeg(image(24, 40, 3, seed=8), quality=80)
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + n]
        i += n
    out += data[i:]
    assert b"\xff\xc4" not in out[:i]
    _same_as_pil(bytes(out))
    np.testing.assert_array_equal(jpeg.decode(bytes(out)), jpeg.decode(data))


def _pad(data, n):
    """``data`` with ``n`` (≥ 4) bytes of COM segments after its SOI:
    every later byte ``n`` further into the stream."""
    out = bytearray(data[:2])
    while n:
        k = min(n, 65537)  # a segment: marker, length, up to 65533 bytes
        if 0 < n - k < 4:
            k -= 4
        out += b"\xff\xfe" + (k - 2).to_bytes(2, "big") + b"c" * (k - 4)
        n -= k
    return bytes(out + data[2:])


@pytest.mark.parametrize("name", ["sof9_restart_dac", "sof10"])
@pytest.mark.parametrize("pad", [65536 - 700, 65536 - 300, 65536 - 64,
                                 65536 + 40, 2 * 65536 - 900])
def test_arithmetic_scans_against_pils_reads(name, pad):
    """libjpeg cannot suspend an arithmetic decoder and PIL hands it the
    stream in 64 KiB reads: PIL refuses a stream whose arithmetic scan
    reads past the read that holds its header, and decodes it where the
    same scan lies inside one read. The port follows, both ways."""
    data = _pad((GOLDEN / f"jpeg_{name}.jpg").read_bytes(), pad)
    try:
        ref = _pil_rgb(data)
    except OSError:
        with pytest.raises(ValueError, match="64 KiB"):
            jpeg.decode(data)
    else:
        np.testing.assert_array_equal(jpeg.decode(data), ref)


# ----------------------------------------------------- lossless (SOF3)

@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt,restart_rows", [(0, 0), (2, 3)])
def test_lossless_predictors_equal_pil(psv, pt, restart_rows):
    img = image(23, 30, 3, seed=psv)
    _same_as_pil(lossless_jpeg([img[..., i] for i in range(3)],
                               [(1, 1)] * 3, psv, pt, restart_rows))


@pytest.mark.parametrize("samp", [
    [(2, 2), (1, 1), (1, 1)], [(4, 1), (1, 1), (1, 1)],
    [(1, 2), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 1)]], ids=str)
def test_lossless_sampling_equals_pil(samp):
    """libjpeg-turbo 3.1 reads a lossless stream with no JFIF or Adobe
    marker as RGB whatever its component ids, and upsamples it by
    replication (no fancy upsampling for one-sample blocks)."""
    img = image(21, 26, 3, seed=1)
    hmax, vmax = max(h for h, _ in samp), max(v for _, v in samp)
    planes = [img[::vmax // v, ::hmax // h, i]
              for i, (h, v) in enumerate(samp)]
    _same_as_pil(lossless_jpeg(planes, samp, 5, restart_rows=2))


def test_lossless_grey_is_exact():
    g = image(19, 24, 1, seed=2)[..., 0]
    data = lossless_jpeg([g], [(1, 1)], 4)
    _same_as_pil(data)
    np.testing.assert_array_equal(jpeg.decode(data)[..., 0], g)


# ------------------------------------------------------------ the slice

def test_svs_tiles_equal_pil():
    """Every tile of the committed SVS (each level, raw tile streams)
    decodes to PIL's hash."""
    from classpose_tpu_torch.io.tiff_reader import TiffSlide

    path = GOLDEN / "jpeg_region.svs"
    raw = path.read_bytes()
    s = TiffSlide(str(path))
    try:
        assert len(s._levels) == len(SPEC["svs"]["levels"]) == 2
        for page, want in zip(s._levels, SPEC["svs"]["levels"]):
            assert len(page.offsets) == len(want)
            for off, n, w in zip(page.offsets, page.counts, want):
                data = raw[off:off + n]
                assert _sha(jpeg.decode(data)) == _sha(_pil_rgb(data)) == \
                    w["sha256"]
    finally:
        s.close()


def test_svs_read_region_equals_jax_reader():
    """The JAX ``TiffSlide`` (PIL) and the port's read the SVS bitwise at
    every level, whole and across tile borders, with the same MPP."""
    from classpose_tpu.io.tiff_reader import TiffSlide as JaxTiffSlide
    from classpose_tpu.utils import get_slide_resolution as jax_resolution
    from classpose_tpu_torch.io.tiff_reader import TiffSlide
    from classpose_tpu_torch.utils import get_slide_resolution

    path = str(GOLDEN / "jpeg_region.svs")
    ours, ref = TiffSlide(path), JaxTiffSlide(path)
    try:
        assert ours.level_dimensions == ref.level_dimensions == \
            ((2048, 2048), (1024, 1024))
        assert ours.properties == ref.properties
        assert get_slide_resolution(ours) == jax_resolution(ref) == \
            (0.4, 0.4)
        for level, (w, h) in enumerate(ours.level_dimensions):
            d = int(ours.level_downsamples[level])
            for x, y, size in [(0, 0, (w, h)),
                               (w // 2 - 37, h // 2 - 53, (301, 277))]:
                np.testing.assert_array_equal(
                    ours.read_region((x * d, y * d), level, size),
                    np.asarray(ref.read_region((x * d, y * d), level,
                                               size)))
    finally:
        ours.close()
        ref.close()


@pytest.fixture(scope="module")
def svs_runs(tmp_path_factory):
    """JAX ``main`` (``WSI_READER=tiff``) and the port's (its default
    reader) on the committed SVS with the tiny checkpoint of
    ``tests/test_torch_pipeline.py``, at the model's 0.8 µm/px: both read
    level 1, whose four tiles are one of each process."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_pipeline import CFG, LABELS
    from test_torch_wsi_tiff import _run, _tiff_args

    tmp = tmp_path_factory.mktemp("wsi_jpeg")
    shutil.copy(GOLDEN / "jpeg_region.svs", tmp / "slide.svs")
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.8\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    ref = _run("tiff", jax_main, _tiff_args(tmp, tmp / "jax", None))
    got = _run(None, port_main, _tiff_args(tmp, tmp / "port", "cpu"))
    return tmp, ref, got


def test_svs_slide_same_tiles_and_cells(svs_runs):
    from test_torch_wsi_tiff import _same_tiles_and_cells

    _same_tiles_and_cells(svs_runs, 25, 500)


def test_svs_slide_centroids_and_classes_match(svs_runs):
    from test_torch_wsi_tiff import _centroids_and_classes_match

    _centroids_and_classes_match(svs_runs)
