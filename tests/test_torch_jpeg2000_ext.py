"""The port's JPEG 2000 decoder (``classpose_tpu_torch/io/jpeg2000.py`` on
``native/jpeg2000.cpp``) past Aperio's 8-bit raw codestreams, against
PIL's ``Image.open(...).convert("RGB")`` (OpenJPEG 2.5) bit for bit:

- component precisions 1 to 16 bits, unsigned and signed, one to four
  components, both wavelets; 17 bits and more (which PIL reads too) and
  precisions mixed across components;
- JP2 files: PIL's and OpenJPEG's own containers, the colr methods and
  enumerated spaces (sRGB, greyscale, sYCC through PIL's YCbCr path, CMYK,
  an ICC profile), pclr and cmap (PIL's palette), cdef, bpcc, XLBox and
  LBox 0, skipped boxes, and the boxes either reader refuses;
- packed packet headers: streams OpenJPEG wrote with SOP and EPH,
  rewritten (``regenerate_j2k.pack_headers``) with their headers in PPM
  or PPT segments, over several segments and tile-parts, in a layer- and
  a position-driven order, and the packings OpenJPEG refuses;
- the ``j2k_ext_*`` goldens and ``j2k_ext_region.svs`` against the
  hashes of PIL's pixels, and the refused goldens by name;
- damaged copies of the new goldens: a ``ValueError`` or an image of the
  stream's size, never a crash;
- the JAX ``main`` against the port's ``main`` on that SVS's first row of
  tiles (one of each kind).

Where PIL raises, the port raises a ``ValueError`` naming what it
refuses. PIL is used here only; the port never imports it."""

import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from classpose_tpu_torch.io import jpeg2000
from golden import regenerate_j2k as regen
from golden.regenerate_j2k import (box, cdef, cmap, colr, ihdr, pclr,
                                   wrap_jp2)
from golden.jax_native import jax_native_geometry  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


def _pil(data):
    """PIL's pixels, or None where PIL raises."""
    try:
        return regen.pil_rgb(data)
    except Exception:
        return None


def _assert_like_pil(data, refusal=None):
    """The port decodes ``data`` to PIL's pixels, or raises naming
    ``refusal`` where PIL raises."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError, match=refusal):
            jpeg2000.decode(data)
        return
    got = jpeg2000.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert diff.max() == 0, (f"max |diff| {diff.max()}, "
                             f"{(diff > 0).mean():.4%} of samples off")


def _encode(img, **kw):
    return regen._opj(img, numres=3, **kw)


# ------------------------------------------------------------ precision

PRECISIONS = (1, 4, 7, 9, 12, 15, 16)
# every precision with one to four components, signed where precision
# and count have an odd sum, each with both wavelets
PREC_CASES = [(p, nc, (p + nc) % 2 == 1) for p in PRECISIONS
              for nc in (1, 2, 3, 4)]


@pytest.mark.parametrize("wavelet", ["53", "97"])
@pytest.mark.parametrize("prec,nc,signed", PREC_CASES,
                         ids=[f"p{p}-c{n}-{'s' if s else 'u'}"
                              for p, n, s in PREC_CASES])
def test_precision_like_pil(prec, nc, signed, wavelet):
    img = regen._ext_image(21, 26, nc, prec, seed=prec * 4 + nc)
    img[0, 0] = (1 << prec) - 1  # the top of the range, where PIL wraps
    img[0, 1] = 0
    data = _encode(img, prec=prec, signed=signed, mct=int(nc >= 3),
                   irreversible=wavelet == "97")
    assert jpeg2000.info(data) == (21, 26, nc)
    _assert_like_pil(data)


@pytest.mark.parametrize("precs,signed,wavelet", [
    ((12, 4, 16), (False, True, False), "53"),
    ((1, 8, 9, 5), (True, False, True, False), "97"),
    ((16, 3), (False, True), "53"),
    ((20,), (False,), "53"),
    ((24, 17, 20), (True, False, True), "97"),
    ((27, 31, 28), (False, False, True), "53"),
], ids=["12-4-16", "1-8-9-5", "16-3", "20-grey", "24-17-20", "27-31-28"])
def test_mixed_and_wide_precisions_like_pil(precs, signed, wavelet):
    img = np.stack([regen._ext_image(19, 23, 1, p, seed=p)[..., 0]
                    for p in precs], -1)
    data = _encode(img, prec=precs, signed=signed,
                   irreversible=wavelet == "97")
    _assert_like_pil(data)


# ------------------------------------------------------------------ JP2

def _jp2_cases():
    rng = np.random.default_rng(19)
    img4 = rng.integers(0, 256, (12, 15, 4))
    cs4, cs3 = _encode(img4), _encode(img4[..., :3])
    cs2, cs1 = _encode(img4[..., :2]), _encode(img4[..., 0])
    idx = rng.integers(0, 8, (12, 15))
    csi = _encode(idx)
    cs12 = _encode(regen._ext_image(12, 15, 1, 12, seed=3), prec=12)
    cs2i = _encode(np.stack([idx, img4[..., 1]], -1))
    cm3 = cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    sig_ftyp = regen.JP2_SIGNATURE + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    h3 = [ihdr(12, 15, 3, 7), colr(16)]
    return {
        "srgb": wrap_jp2(cs3, h3),
        "sycc": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), colr(18)]),
        "sycc-rgba": wrap_jp2(cs4, [ihdr(12, 15, 4, 7), colr(18)]),
        "grey": wrap_jp2(cs1, [ihdr(12, 15, 1, 7), colr(17)]),
        "grey-alpha": wrap_jp2(cs2, [ihdr(12, 15, 2, 7), colr(17)]),
        "cmyk": wrap_jp2(cs4, [ihdr(12, 15, 4, 7), colr(12)]),
        "unknown-enumcs": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), colr(99)]),
        "icc": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), colr(icc=bytes(40))]),
        "no-colr": wrap_jp2(cs3, [ihdr(12, 15, 3, 7)]),
        "first-colr-counts": wrap_jp2(cs3, h3 + [colr(18)]),
        "method-3-ignored": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), box(
            b"colr", b"\x03\0\0abcd"), colr(18)]),
        "i16": wrap_jp2(cs12, [ihdr(12, 15, 1, 11), colr(17)]),
        "12-bit-as-L": wrap_jp2(cs12, [ihdr(12, 15, 1, 7), colr(17)]),
        "bpcc": wrap_jp2(cs3, [ihdr(12, 15, 3, 255), box(b"bpcc", bytes(
            [7, 7, 7])), colr(16)]),
        "ihdr-rgb-on-grey": wrap_jp2(cs1, [ihdr(12, 15, 3, 7), colr(17)]),
        "ihdr-rgba-on-rgb": wrap_jp2(cs3, [ihdr(12, 15, 4, 7), colr(16)]),
        "pclr": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16),
                               pclr(regen.PALETTE, [7, 7, 7]), cm3]),
        "pclr-4-bit-index": wrap_jp2(_encode(idx, prec=4), [
            ihdr(12, 15, 1, 3), colr(16), pclr(regen.PALETTE, [7, 7, 7]),
            cm3]),
        "pclr-rgba": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16), pclr(
            [(i, 2 * i, 3 * i, 4 * i) for i in range(10)], [7] * 4), cmap(
            [(0, 1, k) for k in range(4)])]),
        "pclr-9-bit": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16), pclr(
            [(300 + i, 20, 30) for i in range(8)], [8, 8, 8]), cm3]),
        "pclr-one-column": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16),
                                          pclr([(i,) for i in range(9)],
                                               [7]), cmap([(0, 1, 0)])]),
        "pclr-five-columns": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16),
                                            pclr([(i, 1, 2, 3, 4) for i in
                                                  range(40)], [7] * 5)]),
        "pclr-alpha": wrap_jp2(cs2i, [ihdr(12, 15, 2, 7), colr(16),
                                      pclr(regen.PALETTE, [7, 7, 7]), cm3]),
        "cdef-reordered": wrap_jp2(cs3, h3 + [cdef([(0, 0, 3), (1, 0, 2),
                                                    (2, 0, 1)])]),
        "xlbox": wrap_jp2(cs3, h3, jp2h_xl=True, jp2c="xl"),
        "lbox-0-codestream": wrap_jp2(cs3, h3, jp2c="to_end"),
        "skipped-boxes": wrap_jp2(cs3, h3 + [box(b"res ", box(
            b"resc", bytes(10)))], before=box(b"xml ", b"<a/>")
            + box(b"uuid", bytes(20)) + box(b"jp2i", b"x"),
            after=box(b"xml ", b"<b/>")),
        "misplaced-colr": sig_ftyp + box(b"jp2h", ihdr(12, 15, 3, 7))
        + colr(18) + box(b"jp2c", cs3),
        # refused by PIL or OpenJPEG
        "refused-greyscale-rgb": wrap_jp2(cs3, [ihdr(12, 15, 3, 7),
                                                colr(17)]),
        "refused-srgb-grey": wrap_jp2(cs1, [ihdr(12, 15, 1, 7), colr(16)]),
        "refused-esycc": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), colr(24)]),
        "refused-cmyk-rgb": wrap_jp2(cs3, [ihdr(12, 15, 3, 7), colr(12)]),
        "refused-ihdr-size": wrap_jp2(cs3, [ihdr(12, 16, 3, 7), colr(16)]),
        "refused-ihdr-5-components": wrap_jp2(cs3, [ihdr(12, 15, 5, 7)]),
        "refused-empty-icc": wrap_jp2(cs3, [ihdr(12, 15, 3, 7),
                                            colr(icc=b"")]),
        "refused-bpcc-size": wrap_jp2(cs3, [ihdr(12, 15, 3, 255), box(
            b"bpcc", bytes([7, 7]))]),
        "refused-pclr-greyscale": wrap_jp2(csi, [
            ihdr(12, 15, 1, 7), colr(17), pclr(regen.PALETTE, [7, 7, 7]),
            cm3]),
        "refused-pclr-300-colours": wrap_jp2(csi, [
            ihdr(12, 15, 1, 7), colr(16), pclr([(i % 256, i // 256, 0) for
                                                i in range(300)], [7, 7, 7])]),
        "refused-pclr-empty": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16),
                                             pclr([], [7, 7, 7])]),
        "refused-cmap-first": wrap_jp2(csi, [ihdr(12, 15, 1, 7), colr(16),
                                             cm3, pclr(regen.PALETTE,
                                                       [7, 7, 7])]),
        "refused-two-cdef": wrap_jp2(cs3, h3 + [cdef([(0, 0, 1)])] * 2),
        "refused-no-ftyp": regen.JP2_SIGNATURE + box(
            b"jp2h", ihdr(12, 15, 3, 7)) + box(b"jp2c", cs3),
        "refused-codestream-first": sig_ftyp + box(b"jp2c", cs3)
        + box(b"jp2h", ihdr(12, 15, 3, 7)),
        "refused-no-ihdr": wrap_jp2(cs3, [colr(16)]),
        "refused-jp2h-trailing-bytes": sig_ftyp + box(
            b"jp2h", ihdr(12, 15, 3, 7) + b"\0\0\0") + box(b"jp2c", cs3),
        "refused-lbox-0-before-jp2h": sig_ftyp + box(b"xml ", b"a",
                                                     to_end=True),
        "refused-truncated": wrap_jp2(cs3, h3)[:60],
    }


_JP2 = _jp2_cases()


@pytest.mark.parametrize("name", list(_JP2))
def test_jp2_like_pil(name):
    data = _JP2[name]
    assert (_pil(data) is None) == name.startswith("refused-")
    _assert_like_pil(data, refusal="JP2: ")


@pytest.mark.parametrize("mode,prec", [
    ("L", 8), ("LA", 8), ("RGB", 8), ("RGBA", 8), ("I;16", 16)])
def test_pil_container_like_pil(mode, prec):
    """PIL's own JP2 writer (its default container)."""
    nc = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    img = regen._ext_image(23, 30, nc, prec, seed=nc)
    img = img[..., 0].astype(np.uint16) if nc == 1 and prec > 8 else \
        np.squeeze(img.astype(np.uint8))
    data = regen._pil_jp2(img, mode if mode != "I;16" else None)
    assert data.startswith(regen.JP2_SIGNATURE)
    _assert_like_pil(data)


@pytest.mark.parametrize("space,nc,prec", [
    ("srgb", 3, 8), ("sycc", 3, 8), ("grey", 1, 8), ("srgb", 3, 12),
    ("sycc", 3, 12), ("grey", 1, 12), ("srgb", 4, 10), ("grey", 4, 8),
    ("grey", 3, 8)])
def test_openjpeg_container_like_pil(space, nc, prec):
    """OpenJPEG's JP2 writer: ihdr, bpcc where precisions vary, colr."""
    img = regen._ext_image(23, 30, nc, prec, seed=prec)
    data = _encode(img, prec=prec, codec="jp2", colour_space=space)
    _assert_like_pil(data)


# ------------------------------------------------ packed packet headers

# (id, opj_encode options, pack_headers options); none leaves a tile
# without body bytes, which OpenJPEG does not decode
PACKED = [
    ("ppm", dict(), dict()),
    ("ppm-segments-parts", dict(order="RPCL"), dict(parts=3, segments=4)),
    ("ppm-markers-kept", dict(irreversible=True, rates=(20, 6)),
     dict(keep_markers=True, parts=2, segments=2)),
    ("ppm-nppm-short", dict(order="RPCL", tiles=(32, 24)),
     dict(parts=2, nppm_shift=3)),
    ("ppm-tiles", dict(tiles=(24, 16), irreversible=True), dict(segments=2)),
    ("ppt", dict(), dict()),
    ("ppt-segments-parts", dict(order="RPCL"), dict(parts=3, segments=2)),
    ("ppt-markers-kept", dict(irreversible=True, rates=(20, 6)),
     dict(keep_markers=True, parts=2)),
    ("ppt-tiles", dict(tiles=(24, 16), order="CPRL"), dict(parts=2)),
]


def _sop_eph_stream(seed, **kw):
    return regen._sop_eph(regen.image(45, 52, 3, seed=seed), mct=1, **kw)


@pytest.mark.parametrize("case", PACKED, ids=[c[0] for c in PACKED])
def test_packed_headers_like_pil(case):
    name, enc, pack = case
    cs = _sop_eph_stream(PACKED.index(case), **enc)
    data = regen.pack_headers(cs, name.split("-")[0], **pack)
    want = _pil(data)
    assert want is not None and np.array_equal(want, _pil(cs))
    _assert_like_pil(data)


def _cut_last_headers(ppm: bytes, k: int) -> bytes:
    """A one-segment PPM stream with the last ``k`` header bytes and its
    Nppm ``k`` short: the last packets' headers run past the end."""
    i = ppm.index(b"\xff\x60")
    n = struct.unpack_from(">H", ppm, i + 2)[0]
    nppm = struct.unpack_from(">I", ppm, i + 5)[0]
    seg = (b"\xff\x60" + struct.pack(">HB", n - k, 0)
           + struct.pack(">I", nppm - k) + ppm[i + 9:i + 2 + n - k])
    return ppm[:i] + seg + ppm[i + 2 + n:]


def _refused_packings():
    cs = _sop_eph_stream(50)
    ppm1 = regen.pack_headers(cs, "ppm")
    ppm = regen.pack_headers(cs, "ppm", segments=2)
    ppt = regen.pack_headers(cs, "ppt", segments=2)
    i = ppm.index(b"\xff\x60")
    second = ppm.index(b"\xff\x60", i + 2)
    j = ppt.index(b"\xff\x61")
    k = ppt.index(b"\xff\x61", j + 2)
    sot = ppt.index(b"\xff\x90")
    empty = regen.pack_headers(regen._sop_eph(
        regen.image(45, 4, 3, seed=4), rates=(20, 6)), "ppt")
    return {
        "nppm-past-the-end": (regen.pack_headers(cs, "ppm", nppm_extra=5),
                              "PPM: Nppm runs past"),
        "nppm-short": (_cut_last_headers(ppm1, 1), None),
        "zppm-twice": (ppm[:second + 4] + b"\x00" + ppm[second + 5:],
                       "PPM: index 0 read twice"),
        "zppt-twice": (ppt[:k + 4] + b"\x00" + ppt[k + 5:],
                       "PPT: index 0 read twice"),
        "ppt-in-main-header": (ppt[:sot] + ppt[j:k] + ppt[sot:],
                               "PPT marker in the main header"),
        "empty-tile": (empty, "has no data"),
    }


_REFUSED_PACKINGS = _refused_packings()


@pytest.mark.parametrize("name", list(_REFUSED_PACKINGS))
def test_packed_headers_refused_like_pil(name):
    data, word = _REFUSED_PACKINGS[name]
    if word is None:  # a short last run: PIL and the port read zeros
        _assert_like_pil(data)
        return
    assert _pil(data) is None
    with pytest.raises(ValueError, match=word):
        jpeg2000.decode(data)


# -------------------------------------------------------------- goldens

def _golden():
    return json.loads((GOLDEN / regen.JSON_NAME).read_text())


@pytest.mark.parametrize("name", list(regen.ext_streams()))
def test_ext_golden(name):
    """The committed stream decodes to PIL's pixels, and PIL still decodes
    it so (the hash ``chip_smoke.py`` checks on the card)."""
    data = (GOLDEN / name).read_bytes()
    want = _golden()["ext_streams"][name]
    got = jpeg2000.decode(data)
    assert list(got.shape) == want["shape"]
    assert regen.sha256(got) == want["sha256"]
    assert regen.sha256(regen.pil_rgb(data)) == want["sha256"]


@pytest.mark.parametrize("name", list(regen.refused_streams()))
def test_refused_golden(name):
    word = _golden()["refused"][name]
    with pytest.raises(ValueError, match=word):
        jpeg2000.decode((GOLDEN / name).read_bytes())


def test_ext_golden_svs():
    """``j2k_ext_region.svs``: 16 lossless tiles of 512², a kind in turn,
    each decoding to PIL's hash; together the slide's region exactly; the
    new goldens stay under 150 KB and the SVS under 4 MB."""
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.utils import get_slide_resolution

    g = _golden()
    path = GOLDEN / regen.EXT_SVS_NAME
    s = TiffSlide(str(path))
    try:
        p = s._levels[0]
        assert s.level_dimensions == ((regen.SVS_REGION,) * 2,)
        assert (p.compression, p.tile_width) == (33005, regen.SVS_TILE)
        assert get_slide_resolution(s) == (regen.SVS_MPP, regen.SVS_MPP)
        raw = path.read_bytes()
        streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
        assert len(streams) == len(g["ext_svs"]["tiles"]) == 16
        kinds = [(st.startswith(regen.JP2_SIGNATURE), b"\xff\x60" in st[:400],
                  b"\xff\x61" in st[:600]) for st in streams]
        assert kinds[0:4] == [(False, False, False), (True, False, False),
                              (False, True, False), (False, False, True)]
        for data, h in zip(streams, g["ext_svs"]["tiles"]):
            assert regen.sha256(jpeg2000.decode(data)) == h
        region = s.read_region((0, 0), 0, (regen.SVS_REGION,) * 2)[..., :3]
    finally:
        s.close()
    slide, _ = synthetic_wsi(**regen.SLIDE)
    side = regen.SVS_REGION
    assert np.array_equal(region, slide._level0[:side, :side])
    small = sum((GOLDEN / n).stat().st_size
                for n in list(g["ext_streams"]) + list(g["refused"]))
    assert small < 150_000 and path.stat().st_size < 4_000_000


def test_threads_agree():
    """The new paths keep no shared state: the ext goldens decoded on four
    threads equal the serial decodes."""
    streams = [(GOLDEN / n).read_bytes() for n in regen.ext_streams()]
    serial = [jpeg2000.decode(st) for st in streams]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(jpeg2000.decode, streams * 3))
    for k, got in enumerate(threaded):
        np.testing.assert_array_equal(got, serial[k % len(streams)])


_FUZZED = ("j2k_ext_ppm.j2k", "j2k_ext_ppt.j2k", "j2k_ext_icc_cdef_xl.jp2",
           "j2k_ext_pclr.jp2", "j2k_ext_prec20_signed_97.j2k")


@settings(max_examples=300, deadline=None)
@given(which=st.integers(0, len(_FUZZED) - 1),
       cut=st.floats(0, 1), edits=st.lists(st.tuples(
           st.floats(0, 1, exclude_max=True), st.integers(0, 255)),
           max_size=4))
def test_damaged_streams_raise_or_decode(which, cut, edits):
    """A golden cut short and bytes changed anywhere (boxes, packed
    headers, wide samples): a ``ValueError`` or an image of the size the
    header gives, never a crash."""
    data = bytearray((GOLDEN / _FUZZED[which]).read_bytes())
    for frac, value in edits:
        data[int(frac * len(data))] = value
    data = bytes(data[:max(1, int(cut * len(data)))])
    try:
        h, w, _ = jpeg2000.info(data)
        out = jpeg2000.decode(data)
    except ValueError:
        return
    assert out.shape == (h, w, 3)


# ------------------------------------------------- the CLI, JAX against port

@pytest.fixture(scope="module")
def ext_runs(tmp_path_factory):
    """JAX ``main`` (``WSI_READER=tiff``: PIL decodes the tiles) and the
    port's (``WSI_READER`` unset) on the committed SVS's first row of
    tiles, one of each kind, as a 2048 × 512 SVS."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_pipeline import CFG, LABELS, _args

    tmp = tmp_path_factory.mktemp("wsi_j2k_ext")
    path = GOLDEN / regen.EXT_SVS_NAME
    s = TiffSlide(str(path))
    p = s._levels[0]
    s.close()
    raw = path.read_bytes()
    row = [raw[o:o + n] for o, n in list(zip(p.offsets, p.counts))[:4]]
    side, tile = regen.SVS_REGION, regen.SVS_TILE
    regen.write_tiff(tmp / "slide.svs", [(side, tile, row)], tile,
                     f"Aperio Image Library v12.0.15\r\n{side}x{tile} "
                     f"({tile}x{tile}) J2K|AppMag = 20|MPP = {regen.SVS_MPP}",
                     33005, 2)
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))

    def args(out, device):
        a = _args(tmp, out, device)
        a.slide_path, a.mpp = str(tmp / "slide.svs"), None
        return a

    old = os.environ.pop("WSI_READER", None)
    try:
        os.environ["WSI_READER"] = "tiff"
        ref = jax_main(args(tmp / "jax", None))
        os.environ.pop("WSI_READER")
        got = port_main(args(tmp / "port", "cpu"))
    finally:
        os.environ.pop("WSI_READER", None)
        if old is not None:
            os.environ["WSI_READER"] = old
    return tmp, ref, got


def test_ext_slide_same_tiles_and_cells(ext_runs):
    _, ref, got = ext_runs
    assert got["n_tiles"] == ref["n_tiles"] == 8
    assert ref["n_cells"] >= 100
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]


def test_ext_slide_same_cells_sorted(ext_runs):
    """Both readers give the same pixels; the cells, sorted, agree: ≥ 99%
    of the port's within 1 px of a JAX cell of the same class."""
    from scipy.spatial import cKDTree

    from test_torch_pipeline import _centroids

    tmp, _, _ = ext_runs
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    ref_order, order = np.lexsort(ref_pts.T), np.lexsort(pts.T)
    ref_pts, pts = ref_pts[ref_order], pts[order]
    ref_names = [ref_names[i] for i in ref_order]
    names = [names[i] for i in order]
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= 0.99
