"""The port's JPEG decoder on damaged streams, against PIL 12.1 on
libjpeg-turbo 3.1 (what the JAX ``TiffSlide`` runs on a compression-7
tile): on every input the port decodes PIL's pixels bit for bit, or
raises ``ValueError`` where PIL raises.

- truncation: every cut point of four small PIL streams (baseline,
  progressive, optimized tables, restart interval), seeded random cuts of
  random PIL streams and of the committed arithmetic and lossless goldens,
  and cuts of streams past PIL's 64 KiB reads;
- corrupt entropy data: the two named 64 × 64 inputs (one byte set to
  0x55 at offsets 986 and 629) and seeded 1-3-byte edits of PIL streams
  and of the arithmetic and lossless goldens: bad Huffman codes, markers
  inside a scan, wrong restart markers, runs past coefficient 63, bad
  arithmetic codes, and coefficients large enough for the SIMD inverse
  DCT's 16-bit arithmetic to wrap and saturate;
- the slide: ``tests/golden/jpeg_region.svs`` with one tile cut by its EOI
  stops the JAX ``main`` and the port's with ``RuntimeError("slide reader
  thread failed")``, and with one tile edited decodes to PIL's digest
  (``tests/golden/jpeg_damaged.json``).

PIL is used here only; the port never imports it."""

import glob
import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from classpose_tpu_torch.io import jpeg
from golden.jax_native import jax_native_geometry  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
sys.path.insert(0, str(GOLDEN))
import jpeg_damage  # noqa: E402

KINDS = {"baseline": {}, "progressive": dict(progressive=True),
         "optimized": dict(optimize=True),
         "restart": dict(restart_marker_blocks=2)}


def _pil(data):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _port(data):
    try:
        return jpeg.decode(data)
    except ValueError:
        return None


def _agree(data) -> str | None:
    """None where both decode the same pixels or both refuse, else what
    differs."""
    a, b = _pil(data), _port(data)
    if a is None or b is None:
        return None if (a is None) == (b is None) else \
            f"PIL {'refuses' if a is None else 'decodes'}, the port " \
            f"{'refuses' if b is None else 'decodes'}"
    if a.shape != b.shape or not np.array_equal(a, b):
        return f"{int((a != b).any(-1).sum())} pixels differ"
    return None


def _check(cases):
    bad = [(what, diff) for what, data in cases
           if (diff := _agree(data)) is not None]
    assert not bad, f"{len(bad)} of {len(cases)} differ: {bad[:5]}"


def _stream(rng, kind, max_side=120):
    h, w = (int(v) for v in rng.integers(1, max_side, 2))
    mode = str(rng.choice(["RGB", "L", "RGB", "CMYK"]))
    img = rng.normal(128, 60, (h, w, 4)).clip(0, 255).astype(np.uint8)
    if rng.random() < 0.5:
        img = (img // 32 * 32).astype(np.uint8)
    im = Image.fromarray(img, "CMYK") if mode == "CMYK" else \
        Image.fromarray(img[..., :3]).convert(mode)
    kw = dict(KINDS[kind], quality=int(rng.integers(5, 100)),
              subsampling=int(rng.integers(0, 3)))
    if kind == "restart":
        kw["restart_marker_blocks"] = int(rng.integers(1, 6))
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _goldens(pattern):
    return [(Path(p).stem, Path(p).read_bytes())
            for p in sorted(glob.glob(str(GOLDEN / pattern)))]


def _edit(rng, data, n_max=3):
    """1 to n_max bytes of the scans (from the first SOS on) set at
    random."""
    out = bytearray(data)
    sos = data.find(b"\xff\xda")
    for _ in range(int(rng.integers(1, n_max + 1))):
        out[int(rng.integers(sos + 2, len(out) - 2))] = \
            int(rng.integers(0, 256))
    return bytes(out)


# ------------------------------------------------------------ named inputs

def _named_stream():
    img = np.random.default_rng(0).normal(128, 50, (64, 64, 3))
    buf = io.BytesIO()
    Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=75)
    return buf.getvalue()


@pytest.mark.parametrize("offset", [986, 629])
def test_named_edit_decodes_as_pil(offset):
    """986: a bad Huffman code (the port used to raise); 629: a run past
    coefficient 63 whose block the SIMD IDCT saturates (29 pixels used to
    differ, by up to 252)."""
    data = bytearray(_named_stream())
    assert len(data) == 2616 and data.find(b"\xff\xda") == 609
    data[offset] = 0x55
    a, b = _pil(bytes(data)), _port(bytes(data))
    assert a is not None and b is not None
    np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------ truncation

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_cut_of_a_small_stream(kind):
    img = np.random.default_rng(1).normal(128, 60, (20, 27, 3))
    buf = io.BytesIO()
    Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
        buf, "JPEG", quality=70, **KINDS[kind])
    data = buf.getvalue()
    _check([(c, data[:c]) for c in range(len(data))])
    assert _port(data) is not None


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_random_cuts(kind):
    rng = np.random.default_rng(list(KINDS).index(kind))
    cases = []
    for i in range(80):
        data = _stream(rng, kind)
        c = int(rng.integers(2, len(data)))
        cases.append((i, data[:c]))
    _check(cases)


def test_random_cuts_of_arithmetic_and_lossless_goldens():
    rng = np.random.default_rng(7)
    streams = _goldens("jpeg_sof[39]*.jpg") + _goldens("jpeg_sof10*.jpg")
    cases = []
    for i in range(120):
        name, data = streams[i % len(streams)]
        c = int(rng.integers(data.find(b"\xff\xda"), len(data)))
        cases.append((f"{name}[:{c}]", data[:c]))
    _check(cases)


# ------------------------------------------------------------ corrupt data

@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fuzzed_edits(kind):
    rng = np.random.default_rng(10 + list(KINDS).index(kind))
    _check([(i, _edit(rng, _stream(rng, kind))) for i in range(80)])


FAMILIES = ["jpeg_sof9*.jpg", "jpeg_sof10*.jpg", "jpeg_sof3*.jpg",
            "jpeg_sof2*.jpg"]


@pytest.mark.parametrize("family", FAMILIES)
def test_fuzzed_edits_of_goldens(family):
    """The committed arithmetic (SOF9, SOF10), lossless (SOF3) and
    progressive goldens, which PIL reads."""
    rng = np.random.default_rng(20 + FAMILIES.index(family))
    streams = _goldens(family)
    assert streams
    _check([(streams[i % len(streams)][0],
             _edit(rng, streams[i % len(streams)][1])) for i in range(60)])


def test_streams_past_64k():
    """Streams past PIL's 64 KiB reads: libjpeg-turbo's sequential
    decoder takes its fast path only where the read at hand holds 512
    bytes a block, so edits and cuts near the read's end are where the
    two paths and the suspension show."""
    rng = np.random.default_rng(3)
    cases = []
    for i in range(6):
        img = rng.normal(128, 70, (300, 280, 3)).clip(0, 255)
        kw = [dict(quality=97), dict(quality=95, subsampling=0),
              dict(quality=96, restart_marker_blocks=5)][i % 3]
        buf = io.BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(buf, "JPEG", **kw)
        data = buf.getvalue()
        assert len(data) > 70000
        for _ in range(4):
            out = bytearray(data)
            for _ in range(int(rng.integers(1, 3))):
                out[int(rng.integers(65536 - 3000, 65536 + 500))] = \
                    int(rng.integers(0, 256))
            cases.append((i, bytes(out)))
        cases.append((i, data[:int(rng.integers(65536 - 100, len(data)))]))
    _check(cases)


# ------------------------------------------------------------ the slide

DAMAGED = json.loads((GOLDEN / "jpeg_damaged.json").read_text())


@pytest.mark.parametrize("kind", sorted(jpeg_damage.DAMAGES))
def test_damaged_svs_tile(kind):
    spec = jpeg_damage.DAMAGES[kind]
    assert DAMAGED["damages"][kind] == spec
    raw = (GOLDEN / "jpeg_region.svs").read_bytes()
    data = jpeg_damage.tile_stream(jpeg_damage.damaged(raw, kind),
                                   spec["ifd"], spec["tile"])
    want = DAMAGED["pil"][kind]
    a = _pil(data)
    if "raises" in want:
        assert a is None
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode(data)
        return
    got = jpeg.decode(data)
    for rgb in (a, got):
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == want["sha256"]


def test_truncated_tile_stops_both_mains(tmp_path):
    """JAX ``main`` (``WSI_READER=tiff``, PIL) and the port's (its own
    reader) on the SVS with level 0's first tile (SOF2) cut by its EOI,
    at the slide's 0.4 µm/px (level 0): both stop with the reader
    thread's error."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_pipeline import CFG, LABELS
    from test_torch_wsi_tiff import _run, _tiff_args

    raw = (GOLDEN / "jpeg_region.svs").read_bytes()
    (tmp_path / "slide.svs").write_bytes(
        jpeg_damage.damaged(raw, "truncated"))
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp_path / "ckpt.npz"), cfg=cfg)
    (tmp_path / "config.yaml").write_text(
        f"path: {tmp_path}/ckpt.npz\nmpp: 0.4\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))
    with pytest.raises(RuntimeError, match="slide reader thread failed") \
            as ref:
        _run("tiff", jax_main, _tiff_args(tmp_path, tmp_path / "jax", None))
    assert isinstance(ref.value.__cause__, OSError)
    with pytest.raises(RuntimeError, match="slide reader thread failed") \
            as got:
        _run(None, port_main, _tiff_args(tmp_path, tmp_path / "port", "cpu"))
    assert isinstance(got.value.__cause__, ValueError)
    assert "truncated" in str(got.value.__cause__)
