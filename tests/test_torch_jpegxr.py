"""The port's JPEG XR decoder (``classpose_tpu_torch/native/jpegxr.cpp``,
``io/jpegxr.py``) against the test-side encoder of
``tests/golden/regenerate_jxr.py``, on the CPU.

No JPEG XR reference (jxrlib, imagecodecs, pylibCZIrw) is on any machine
here, so the decoder is held to a test-side encoder written from recall
of ITU-T T.832's forward process, not to the standard's text or jxrlib:
lossless round trips give the source back exactly, lossy ones the
encoder's own reconstruction bit for bit. The two sides may share a
misreading; agreement with ZEN-written streams is unchecked.

- every golden (``jxr_golden.json``) decoded to its recorded pixels, and
  each lossless one to its source; ``info`` against the container;
- round trips of seeded images under seeded settings, encoded here;
- the refused pixel formats by name, at the container and in the
  codestream, and refused header fields by name;
- a seeded fuzz of cuts and byte edits: each case raises ``ValueError``
  or returns pixels of the right shape and dtype (in this process, so a
  crash fails the run); edits inside one tile packet of a hard-tiled
  stream raise or change only that tile; a packet that leaves bytes
  unread or reads past its span raises."""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from golden import regenerate_jxr as jxr

GOLDEN = Path(__file__).parent / "golden"


@functools.lru_cache(maxsize=None)
def _golden() -> dict:
    return json.loads((GOLDEN / "jxr_golden.json").read_text())


@functools.lru_cache(maxsize=None)
def _sources() -> dict:
    return jxr.goldens()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(json.loads(
    (GOLDEN / "jxr_golden.json").read_text())["files"]))
def test_golden_bitwise(name):
    """The decoder's pixels are the encoder's record, shape and dtype
    alike; a lossless golden's are its source; ``info`` reads the
    container."""
    from classpose_tpu_torch.io import jpegxr

    g = _golden()["files"][name]
    data = (GOLDEN / f"{name}.jxr").read_bytes()
    got = jpegxr.decode(data)
    assert list(got.shape) == g["shape"] and str(got.dtype) == g["dtype"]
    assert _sha(got) == g["sha256"], name
    h, w, c, fmt = jpegxr.info(data)
    assert (h, w, c, fmt) == (*g["shape"], g["pixel_format"])
    src, params, exact = _sources()[name]
    assert exact == g["lossless"] == jxr.lossless(params)
    if exact:
        assert np.array_equal(got, src.reshape(got.shape))


def _random_settings(seed: int):
    """A seeded image and seeded settings the encoder takes."""
    rng = np.random.default_rng(1000 + seed)
    fmt = ["8bppGray", "16bppGray", "24bppBGR", "24bppRGB", "32bppBGRA",
           "48bppRGB"][seed % 6]
    _, nch, nbytes, _ = jxr.PIXEL_FORMATS[fmt]
    h, w = (int(v) for v in rng.integers(1, 70, 2))
    img = jxr._texture(rng, h, w, nch, np.uint8 if nbytes == 1 else
                       np.uint16)
    internal = "Y" if nch == 1 else str(rng.choice(["444", "422", "420"]))

    def quant(n):
        mode = int(rng.integers(0, 3)) if n > 1 else 0
        return (mode, tuple(int(v) for v in rng.integers(
            0, 40, [1, 2, n][mode])))

    def plane(fmt_, n):
        return jxr.Plane(fmt=fmt_, scaled=bool(rng.integers(2)),
                         bands=int(rng.integers(0, 4)),
                         dc=("image", quant(n)),
                         lp=("use_dc",) if rng.integers(2) else
                         ("image", quant(n)),
                         hp=("use_lp",) if rng.integers(2) else
                         ("image", quant(n)))

    window = None
    if rng.integers(2):
        top, left = (int(v) for v in rng.integers(0, 20, 2))
        window = (top, left, (-(top + h)) % 16 + 16 * int(rng.integers(2)),
                  (-(left + w)) % 16)
        window = tuple(min(v, 63) for v in window)
        if (window[0] + h + window[2]) % 16 or \
                (window[1] + w + window[3]) % 16:
            window = None
    mbw = ((window[1] + w + window[3]) if window else -(-w // 16) * 16) // 16
    mbh = ((window[0] + h + window[2]) if window else -(-h // 16) * 16) // 16
    tile_w = (1,) * min(mbw - 1, int(rng.integers(0, 3)))
    tile_h = (1,) * min(mbh - 1, int(rng.integers(0, 3)))
    alpha = planar = None
    if "A" in jxr.PIXEL_FORMATS[fmt][3]:
        if rng.integers(2):
            alpha = plane("Y", 1)
        else:
            planar = plane("Y", 1)
    params = jxr.Params(
        pixel_format=fmt, plane=plane(internal, 1 if nch == 1 else 3),
        alpha=alpha, planar_alpha=planar, overlap=int(rng.integers(0, 3)),
        frequency=bool(rng.integers(2)), tile_w=tile_w, tile_h=tile_h,
        hard=bool(rng.integers(2)), window=window,
        short_header=bool(rng.integers(2)), trim=int(rng.integers(0, 3)),
        shift_bits=int(rng.integers(0, 3)) if nbytes == 2 else 0)
    return img, params


@pytest.mark.parametrize("seed", range(12))
def test_seeded_round_trip(seed):
    """Images and settings drawn from a seed, encoded here, decode to the
    encoder's reconstruction bit for bit."""
    from classpose_tpu_torch.io import jpegxr

    img, params = _random_settings(seed)
    data, rec = jxr.encode(img, params)
    got = jpegxr.decode(data)
    assert got.dtype == rec.dtype and np.array_equal(got, rec), params


@pytest.mark.parametrize("name", sorted(json.loads(
    (GOLDEN / "jxr_golden.json").read_text())["refused"]))
def test_refused_formats(name):
    """Each refused pixel format raises naming it at the container, and
    its codestream raises naming the header field and value."""
    from classpose_tpu_torch.io import jpegxr

    g = _golden()["refused"][name]
    data = (GOLDEN / f"{name}.jxr").read_bytes()
    with pytest.raises(ValueError, match=g["format"]):
        jpegxr.decode(data)
    with pytest.raises(ValueError, match=g["format"]):
        jpegxr.info(data)
    assert jpegxr.container(data).pixel_format == g["format"]
    with pytest.raises(ValueError, match=g["codestream"]):
        jpegxr.decode_codestream(jpegxr.container(data).image)


def _codestream(name: str) -> bytes:
    from classpose_tpu_torch.io import jpegxr

    return jpegxr.container((GOLDEN / f"{name}.jxr").read_bytes()).image


def _set_bits(b: bytes, pos: int, n: int, v: int) -> bytes:
    x = int.from_bytes(b, "big")
    shift = 8 * len(b) - pos - n
    x = (x & ~(((1 << n) - 1) << shift)) | (v << shift)
    return x.to_bytes(len(b), "big")


# (golden, first bit, bits, value, what the refusal names); the image
# header of jxr_bgr24_ol1 is 128 bits, its plane header follows
FIELDS = [
    ("jxr_bgr24_ol1", 64, 4, 2, "RESERVED_B"),
    ("jxr_bgr24_ol1", 69, 3, 0, "RESERVED_C 0"),
    ("jxr_bgr24_ol1", 74, 3, 1, "SPATIAL_XFRM_SUBORDINATE 1"),
    ("jxr_bgr24_ol1", 78, 2, 3, "OVERLAP_MODE 3"),
    ("jxr_bgr24_ol1", 84, 3, 2, "RESERVED_D 2"),
    ("jxr_bgr24_ol1", 88, 4, 1, "OUTPUT_CLR_FMT YUV420"),
    ("jxr_bgr24_ol1", 88, 4, 3, "OUTPUT_CLR_FMT YUV444"),
    ("jxr_bgr24_ol1", 92, 4, 5, "OUTPUT_BITDEPTH reserved 5"),
    ("jxr_bgr24_ol1", 128, 3, 0, "INTERNAL_CLR_FMT YONLY with "
                                 "OUTPUT_CLR_FMT RGB"),
    ("jxr_bgr24_ol1", 128, 3, 7, "INTERNAL_CLR_FMT reserved 7"),
    ("jxr_bgr24_ol1", 132, 4, 5, "BANDS_PRESENT 5"),
    ("jxr_bgr24_ol1", 145, 2, 3, "channel mode 3"),
    ("jxr_rgb24_ol2_frequency_uniform_tiles", 77, 1, 0,
     "INDEX_TABLE_PRESENT_FLAG 0"),
    ("jxr_gray8_ol0", 87, 1, 1, "ALPHA_IMAGE_PLANE_FLAG with "
                                "OUTPUT_CLR_FMT YONLY"),
]


@pytest.mark.parametrize("name,pos,n,v,match", FIELDS)
def test_refused_fields(name, pos, n, v, match):
    """Reserved values and features the decoder does not read raise a
    ValueError that names the header field and its value."""
    from classpose_tpu_torch.io import jpegxr

    cs = _set_bits(_codestream(name), pos, n, v)
    with pytest.raises(ValueError, match=match):
        jpegxr.decode_codestream(cs)


def test_refused_containers():
    """An unknown GUID, a file that is not JPEG XR, and a codestream past
    the file raise by name."""
    from classpose_tpu_torch.io import jpegxr

    data = bytearray((GOLDEN / "jxr_bgr24_ol1.jxr").read_bytes())
    tags = jpegxr._tags(bytes(data))
    g = bytes(data).index(tags[jpegxr.TAG_PIXEL_FORMAT])
    bad = bytearray(data)
    bad[g + 15] = 0x77
    with pytest.raises(ValueError, match="6FDDC324-4E03-4BFE-B185-"
                                         "3D77768DC977"):
        jpegxr.decode(bytes(bad))
    with pytest.raises(ValueError, match="not a JPEG XR file"):
        jpegxr.decode(b"II*\0" + bytes(data[4:]))
    with pytest.raises(ValueError, match="past the file"):
        jpegxr.decode(bytes(data[:-10]))


@pytest.mark.parametrize("name", ["jxr_bgr24_ol1",
                                  "jxr_rgb24_ol2_frequency_uniform_tiles",
                                  "jxr_bgra32_planar_alpha",
                                  "jxr_yuv420_scaled_ol2",
                                  "jxr_tile_quantizers_frequency_hard"])
def test_fuzzed_streams(name):
    """Cuts and 1-4 byte edits of a golden: each raises ValueError or
    gives pixels of the shape and dtype its header says."""
    from classpose_tpu_torch.io import jpegxr

    raw = (GOLDEN / f"{name}.jxr").read_bytes()
    rng = np.random.default_rng(sum(raw) & 0xFFFF)
    decoded = 0
    for k in range(800):
        b = bytearray(raw)
        if k % 4 == 0:
            b = b[:rng.integers(0, len(b))]
        else:
            for _ in range(rng.integers(1, 5)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
        try:
            px = jpegxr.decode(bytes(b))
        except ValueError:
            continue
        h, w, c, _ = jpegxr.info(bytes(b))
        assert px.shape == (h, w, c) and px.dtype in (np.uint8, np.uint16)
        decoded += 1
    assert decoded > 0


@pytest.mark.parametrize("name", ["jxr_bgr24_hard_nonuniform_tiles",
                                  "jxr_tile_quantizers_frequency_hard"])
def test_packet_edits_stay_in_their_tile(name):
    """With hard tiles, a 1-3 byte edit inside one tile packet raises
    ValueError or changes no pixel outside that packet's tile: a packet
    is decoded within its span of the index table and nowhere else."""
    from classpose_tpu_torch.io import jpegxr

    raw = (GOLDEN / f"{name}.jxr").read_bytes()
    src, params, _ = _sources()[name]
    spans = []
    data, _ = jxr.encode(src, params, spans)
    assert data == raw and len(spans) > 1
    want = jpegxr.decode(raw)
    rng = np.random.default_rng(len(raw))
    raised = 0
    for k in range(120):
        (a, b), (y0, y1, x0, x1) = spans[k % len(spans)]
        bad = bytearray(raw)
        for _ in range(rng.integers(1, 4)):
            bad[rng.integers(a + 4, b)] ^= int(rng.integers(1, 256))
        try:
            got = jpegxr.decode(bytes(bad))
        except ValueError:
            raised += 1
            continue
        outside = np.ones(want.shape[:2], bool)
        outside[y0:y1, x0:x1] = False
        assert np.array_equal(got[outside], want[outside]), (k, a, b)
    assert raised > 0


def test_packet_bounds():
    """A codestream with a byte past its last packet, and one whose last
    packet lost its last byte, raise by name."""
    from classpose_tpu_torch.io import jpegxr

    raw = (GOLDEN / "jxr_bgr24_ol1.jxr").read_bytes()
    c = jpegxr.container(raw)
    with pytest.raises(ValueError, match="ends 1 bytes before the next "
                                         "packet's offset"):
        jpegxr.decode(c._replace(image=c.image + b"\0"))
    with pytest.raises(ValueError, match="read past its end"):
        jpegxr.decode(c._replace(image=c.image[:-1]))
