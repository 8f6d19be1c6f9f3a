"""The port's JPEG 2000 decoder (``classpose_tpu_torch/io/jpeg2000.py`` on
``native/jpeg2000.cpp``) against PIL's OpenJPEG 2.5, bit for bit, on
streams PIL encodes at test time: sizes from 1 × N up, one, three and four
components, the reversible 5/3 and the irreversible 9/7 wavelet (both
bitwise: no case needs a tolerance), MCT off and on, 1 to 7 resolutions,
code-blocks from 4 × 4 to 64 × 64 and non-square, custom precincts, the
five progression orders, one to three layers in rates and dB modes,
tiles with image and tile offsets, PLT, a comment and signed components;
what PIL's ``save`` does not expose, through OpenJPEG's own encoder
(``regenerate_j2k.opj_encode``): the six code-block style flags,
SOP/EPH, ROI and POC; derived quantization through a rewritten QCD; a
512² slide tile at the Aperio settings; the committed goldens; every
refusal by name; truncated and corrupted streams (hypothesis), which
raise ``ValueError`` and never crash.

PIL is used here only, to make and decode reference streams; the port
never imports it."""

import functools
import io
import json
import struct
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from classpose_tpu_torch.io import jpeg2000
from golden import regenerate_j2k as regen

GOLDEN = Path(__file__).parent / "golden"

# (id, (height, width, PIL mode), PIL save options); each case runs with
# both wavelets. None of these trips OpenJPEG's encoder, which crashes on
# some tiny inputs (dB mode on a one-pixel side, offsets without tiles,
# more resolutions than a small precinct or tile allows).
MATRIX = [
    ("1xN", (1, 37, "RGB"), dict(num_resolutions=1)),
    ("Nx1", (29, 1, "L"), dict(num_resolutions=1)),
    ("2x2", (2, 2, "RGB"), dict(num_resolutions=2)),
    ("odd-sides", (37, 45, "RGB"), {}),
    ("grey", (40, 33, "L"), {}),
    ("rgba", (33, 40, "RGBA"), {}),
    ("mct", (37, 45, "RGB"), dict(mct=1)),
    ("mct-rgba", (31, 30, "RGBA"), dict(mct=1)),
    ("res1", (20, 21, "RGB"), dict(num_resolutions=1)),
    ("res2", (20, 21, "RGB"), dict(num_resolutions=2)),
    ("res3", (33, 35, "RGB"), dict(num_resolutions=3)),
    ("res4", (33, 35, "RGB"), dict(num_resolutions=4)),
    ("res5", (65, 70, "RGB"), dict(num_resolutions=5)),
    ("res6", (65, 70, "L"), dict(num_resolutions=6)),
    ("res7", (129, 130, "L"), dict(num_resolutions=7)),
    ("cblk4x4", (37, 45, "RGB"), dict(codeblock_size=(4, 4))),
    ("cblk64x64", (130, 140, "L"), dict(codeblock_size=(64, 64))),
    ("cblk8x32", (45, 70, "RGB"), dict(codeblock_size=(8, 32))),
    ("cblk64x4", (45, 70, "RGB"), dict(codeblock_size=(64, 4))),
    ("cblk16x64", (100, 50, "L"), dict(codeblock_size=(16, 64))),
    ("precincts", (61, 70, "RGB"), dict(precinct_size=(16, 16),
                                        num_resolutions=4)),
    ("precincts-nonsquare", (61, 70, "RGB"), dict(
        precinct_size=(64, 16), num_resolutions=3, codeblock_size=(8, 8))),
    ("LRCP", (61, 70, "RGB"), dict(progression="LRCP",
                                   quality_layers=[20, 5])),
    ("RLCP", (61, 70, "RGB"), dict(progression="RLCP",
                                   quality_layers=[20, 5])),
    ("RPCL", (61, 70, "RGB"), dict(progression="RPCL",
                                   precinct_size=(32, 32),
                                   num_resolutions=4)),
    ("PCRL", (61, 70, "RGB"), dict(progression="PCRL",
                                   precinct_size=(32, 32),
                                   num_resolutions=4)),
    ("CPRL", (61, 70, "RGB"), dict(progression="CPRL",
                                   precinct_size=(32, 32),
                                   num_resolutions=4)),
    ("rates-1", (50, 60, "RGB"), dict(quality_layers=[20])),
    ("rates-3", (50, 60, "RGB"), dict(quality_layers=[40, 15, 3])),
    ("dB-1", (50, 60, "RGB"), dict(quality_mode="dB", quality_layers=[30])),
    ("dB-3", (50, 60, "RGB"), dict(quality_mode="dB",
                                   quality_layers=[28, 34, 42])),
    ("tiles", (50, 45, "RGB"), dict(tile_size=(16, 24))),
    ("tiles-offsets", (50, 45, "RGB"), dict(
        tile_size=(16, 24), offset=(5, 3), tile_offset=(2, 1))),
    ("tiles-offsets-odd", (43, 39, "L"), dict(
        tile_size=(32, 32), offset=(7, 9), tile_offset=(7, 1),
        num_resolutions=3)),
    # precinct and code-block positions at odd tile and image offsets in
    # the position-driven orders
    ("RPCL-offsets", (50, 45, "RGB"), dict(
        progression="RPCL", tile_size=(32, 32), offset=(5, 3),
        tile_offset=(3, 1), precinct_size=(16, 16), num_resolutions=3)),
    ("PCRL-offsets", (50, 45, "RGB"), dict(
        progression="PCRL", tile_size=(32, 32), offset=(5, 3),
        tile_offset=(3, 1), precinct_size=(16, 16), num_resolutions=3)),
    ("CPRL-offsets", (50, 45, "RGB"), dict(
        progression="CPRL", tile_size=(32, 32), offset=(5, 3),
        tile_offset=(3, 1), precinct_size=(16, 16), num_resolutions=3)),
    ("offsets-past-2^31", (50, 45, "RGB"), dict(
        offset=(4000000005, 3000000001), tile_offset=(4000000000, 3000000000),
        tile_size=(32, 32), num_resolutions=3)),
    ("plt", (50, 60, "RGB"), dict(plt=True, tile_size=(32, 32))),
    ("comment", (30, 20, "RGB"), dict(comment="classpose test")),
    ("signed", (37, 45, "RGB"), dict(signed=True)),
    ("signed-grey", (37, 45, "L"), dict(signed=True, quality_layers=[10])),
    ("mixed", (77, 91, "RGB"), dict(
        mct=1, progression="RPCL", num_resolutions=5,
        codeblock_size=(16, 8), precinct_size=(64, 32),
        quality_layers=[30, 10, 4], tile_size=(48, 40), offset=(3, 2),
        tile_offset=(1, 2), plt=True, comment="x")),
]
_CHANNELS = {"L": 1, "RGB": 3, "RGBA": 4}


def _stream(i, h, w, mode, irreversible, **kw):
    img = regen.image(h, w, _CHANNELS[mode], seed=i)
    if mode == "L":
        img = img[..., 0]
    return regen.encode(img, mode, irreversible=irreversible, **kw)


def _assert_like_pil(data):
    want = regen.pil_rgb(data)
    got = jpeg2000.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want)
    assert diff.max() == 0, (f"max |diff| {diff.max()}, "
                             f"{(diff > 0).mean():.4%} of samples off")


@pytest.mark.parametrize("wavelet", ["53", "97"])
@pytest.mark.parametrize("case", MATRIX, ids=[c[0] for c in MATRIX])
def test_decode_equals_pil(case, wavelet):
    i = MATRIX.index(case)
    _, (h, w, mode), kw = case
    data = _stream(i, h, w, mode, wavelet == "97", **kw)
    assert jpeg2000.info(data) == (h, w, _CHANNELS[mode])
    _assert_like_pil(data)


def _to_derived(data):
    """The stream with its expounded QCD replaced by a derived one that
    keeps the LL band's exponent and mantissa (the other bands' step
    sizes follow from it, Annex E.1.1.1)."""
    i = data.index(b"\xff\x5c")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    sqcd = data[i + 4]
    assert sqcd & 31 == 2
    seg = (b"\xff\x5c" + struct.pack(">H", 5) + bytes([sqcd & 0xE0 | 1])
           + data[i + 5:i + 7])
    return data[:i] + seg + data[i + 2 + n:]


# (id, components, opj_encode options), each with both wavelets, over
# 3 resolutions, 8 × 16 code-blocks and two layers; POC 1 is RLCP, 2
# RPCL, 3 PCRL, 4 CPRL. PIL fails on some streams OpenJPEG writes (SOP or
# EPH with POC; one resolution-split POC at 9/7), so none is here.
OPJ_MATRIX = [
    ("bypass", 3, dict(mode=1)),
    ("reset", 3, dict(mode=2)),
    ("termall", 3, dict(mode=4)),
    ("vertically-causal", 3, dict(mode=8)),
    ("predictable-termination", 3, dict(mode=16)),
    ("segmentation-symbols", 3, dict(mode=32)),
    ("bypass-termall", 3, dict(mode=5)),
    ("bypass-reset-causal", 1, dict(mode=11)),
    ("all-flags", 3, dict(mode=63, mct=1)),
    ("sop", 3, dict(csty=2)),
    ("eph", 3, dict(csty=4)),
    ("sop-eph-flags", 4, dict(csty=6, mode=63)),
    ("roi", 3, dict(roi=(0, 2))),
    ("roi-shift5-mct", 3, dict(roi=(1, 5), mct=1)),
    ("roi-grey-flags", 1, dict(roi=(0, 4), mode=63)),
    ("poc-resolutions", 3, dict(poc=[(0, 0, 2, 2, 3, 0),
                                     (2, 0, 2, 3, 3, 1)])),
    ("poc-layers", 3, dict(poc=[(0, 0, 1, 3, 3, 0), (0, 0, 2, 3, 3, 0)])),
    ("poc-components", 3, dict(poc=[(0, 0, 2, 3, 1, 4),
                                    (0, 1, 2, 3, 3, 2)])),
    ("poc-rpcl-pcrl", 3, dict(poc=[(0, 0, 1, 2, 3, 2),
                                   (0, 0, 2, 3, 3, 3)])),
    ("poc-flags-roi", 3, dict(poc=[(0, 0, 2, 1, 3, 1), (1, 0, 2, 3, 3, 4)],
                              mode=63, roi=(2, 3))),
    ("signed-flags", 3, dict(signed=True, mode=63)),
]


def _opj_stream(i, channels, path, **kw):
    img = regen.image(45, 52, channels, seed=i)
    opts = dict(numres=3, cblk=(8, 16), rates=(20, 6))
    opts.update(kw)
    return regen.opj_encode(img[..., 0] if channels == 1 else img, path,
                            **opts)


@pytest.mark.parametrize("wavelet", ["53", "97"])
@pytest.mark.parametrize("case", OPJ_MATRIX, ids=[c[0] for c in OPJ_MATRIX])
def test_decode_openjpeg_features(case, wavelet, tmp_path):
    i = OPJ_MATRIX.index(case)
    _, channels, kw = case
    data = _opj_stream(i, channels, tmp_path / "s.j2k",
                       irreversible=wavelet == "97", **kw)
    _assert_like_pil(data)


@pytest.mark.parametrize("kw", [
    {}, dict(mct=1, quality_layers=[20]),
    dict(num_resolutions=3, quality_layers=[40, 10], progression="RPCL",
         precinct_size=(16, 16))])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_decode_derived_quantization(kw, mode):
    data = _to_derived(_stream(7, 61, 70, mode, True, **kw))
    _assert_like_pil(data)


@pytest.fixture(scope="module")
def slide_tile():
    """A 512² tile of a synthetic slide at the WSI phase's cell density."""
    from classpose_tpu_torch.io.array_reader import synthetic_wsi

    slide, _ = synthetic_wsi(width=1024, height=1024, n_cells=110, mpp=0.4,
                             seed=0)
    return np.ascontiguousarray(slide._level0[256:768, 256:768])


@pytest.mark.parametrize("kw", [
    dict(irreversible=True, mct=1, quality_layers=[60]),  # the SVS's
    dict(irreversible=True, quality_layers=[30]),
    dict(mct=1),  # lossless 5/3 with the RCT
], ids=["97-rate60-ict", "97-rate30", "53-rct"])
def test_decode_slide_tile(slide_tile, kw):
    _assert_like_pil(regen.encode(slide_tile, **kw))


def test_decode_threads_agree():
    """No state is shared between calls: decodes on four threads equal
    the serial ones."""
    streams = [_stream(i, 61, 70, "RGB", i % 2 == 1, mct=1,
                       quality_layers=[30, 10]) for i in range(12)]
    serial = [jpeg2000.decode(s) for s in streams]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(jpeg2000.decode, streams * 3))
    for k, got in enumerate(threaded):
        np.testing.assert_array_equal(got, serial[k % len(streams)])


# ------------------------------------------------------------ goldens

def _golden():
    return json.loads((GOLDEN / regen.JSON_NAME).read_text())


@pytest.mark.parametrize("name", list(regen.STREAMS))
def test_golden_stream(name):
    """The committed stream decodes to PIL's pixels, and PIL still
    decodes it so (the hash ``chip_smoke.py`` checks on the card)."""
    data = (GOLDEN / f"{name}.j2k").read_bytes()
    want = _golden()["streams"][name]
    got = jpeg2000.decode(data)
    assert list(got.shape) == want["shape"]
    assert regen.sha256(got) == want["sha256"]
    assert regen.sha256(regen.pil_rgb(data)) == want["sha256"]


def test_golden_svs():
    """The committed 33005 SVS: 16 tiles of 512² in one level at MPP 0.4,
    each decoding to the hash of PIL's pixels; the goldens stay under
    512 KiB (the other SVSs aside: their own tests hold their sizes)."""
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.utils import get_slide_resolution

    g = _golden()["svs"]
    s = TiffSlide(str(GOLDEN / regen.SVS_NAME))
    try:
        p = s._levels[0]
        assert s.level_dimensions == ((g["region"], g["region"]),)
        assert (p.compression, p.tile_width) == (33005, g["tile"])
        assert get_slide_resolution(s) == (regen.SVS_MPP, regen.SVS_MPP)
        raw = (GOLDEN / regen.SVS_NAME).read_bytes()
        streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
        assert len(streams) == len(g["tiles"]) == 16
        for data, h in zip(streams, g["tiles"]):
            assert regen.sha256(jpeg2000.decode(data)) == h
            assert regen.sha256(regen.pil_rgb(data)) == h
    finally:
        s.close()
    total = sum(f.stat().st_size for f in GOLDEN.glob("j2k_*")
                if f.name not in (regen.EXT_SVS_NAME, regen.SUB_SVS_NAME,
                                  regen.HT_SVS_NAME))
    assert total <= 512 * 1024


# ----------------------------------------------------------- refusals

def _base_stream(**kw):
    return _stream(3, 37, 45, "RGB", False, **kw)


def _marker(data, code):
    return data.index(bytes([0xFF, code]))


def _insert_main(data, segment):
    """``segment`` put at the end of the main header (before the first
    SOT)."""
    i = _marker(data, 0x90)
    return data[:i] + segment + data[i:]


def _insert_tile(data, segment):
    """``segment`` put in the first tile-part header, its Psot grown."""
    i = _marker(data, 0x90)
    psot = struct.unpack(">I", data[i + 6:i + 10])[0]
    head = data[:i + 6] + struct.pack(">I", psot + len(segment)) \
        + data[i + 10:i + 12]
    return head + segment + data[i + 12:]


def _patch(data, at, value):
    return data[:at] + value + data[at + len(value):]


def _cod_at(data):
    return _marker(data, 0x52)


def _refusals():
    base = _base_stream()
    siz = _marker(base, 0x51)
    cod = _cod_at(base)
    qcd = _marker(base, 0x5C)
    out = {
        "jp2": (None, "JP2: ihdr gives 17 x 16"),
        "precision": (None, "component precision 32 bits"),
        "five-components": (_patch(base, siz + 38, struct.pack(">H", 5)),
                            "5 components"),
        "part2-rsiz": (_patch(base, siz + 4, b"\x80\x00"), "Part-2"),
        "part2-mct": (_patch(base, cod + 8, b"\x02"),
                      "multiple component transform 2"),
        "part2-wavelet": (_patch(base, cod + 13, b"\x02"),
                          "wavelet transform 2"),
        "part2-quant": (_patch(base, qcd + 4, bytes([base[qcd + 4] | 3])),
                        "quantization style 3"),
        "part2-marker": (_insert_main(base, b"\xff\x72\x00\x03\x00"),
                         "Part-2 extension marker 0xFF72"),
        "part2-rgn-style": (_insert_main(
            base, b"\xff\x5e\x00\x05\x00\x01\x03"), "RGN: region style 1"),
        "poc-33-progressions": (_insert_main(base, b"\xff\x5f" + struct.pack(
            ">H", 2 + 7 * 33) + bytes([0, 0, 0, 1, 1, 3, 0]) * 33),
            "more than 32 progressions"),
        "ppm": (_insert_main(base, b"\xff\x60\x00\x09\x00"
                             + struct.pack(">I", 100) + b"\x00\x00"),
                "PPM: Nppm runs past the last PPM segment"),
        "ppt": (_insert_tile(_insert_main(base, b"\xff\x60\x00\x07\x00"
                                          + struct.pack(">I", 0)),
                             b"\xff\x61\x00\x04\x00\x00"),
                "PPT marker in a codestream with PPM"),
        # Part 1 data under the HT style: the HT decoder refuses its 16
        # passes, as OpenJPEG does (at most 3: no placeholder passes)
        "style-ht": (_patch(base, cod + 12, b"\x40"), "16 coding passes"),
        "style-mixed-ht": (_patch(base, cod + 12, b"\x80"),
                           "mixed HT and Part 1 code-blocks"),
        "part15-cap-in-tile-part": (_insert_tile(regen.part15(base),
                                                 regen.CAP),
                                    "in a tile-part header"),
        "part15-cpf-in-tile-part": (_insert_tile(base, regen.CPF),
                                    "in a tile-part header"),
    }
    return out


_REFUSALS = _refusals()


# what PIL refuses as well; the other cases stay refused where PIL reads
# them (Part 2) or fail PIL another way
_PIL_REFUSES = ("jp2", "precision", "ppm", "ppt", "five-components",
                "style-ht", "style-mixed-ht", "part15-cap-in-tile-part",
                "part15-cpf-in-tile-part")


@pytest.mark.parametrize("name", list(_REFUSALS))
def test_refuses_by_name(name):
    data, message = _REFUSALS[name]
    if name == "jp2":  # PIL's default container, its ihdr one wider
        buf = io.BytesIO()
        Image.fromarray(regen.image(16, 16, 3, 0)).save(buf, "JPEG2000")
        data = buf.getvalue()
        i = data.index(b"ihdr") + 8
        data = data[:i] + struct.pack(">I", 17) + data[i + 4:]
    elif name == "precision":  # 16 bits as PIL writes them, SIZ says 32
        buf = io.BytesIO()
        Image.fromarray(np.arange(256, dtype=np.uint16).reshape(16, 16)
                        * 200).save(buf, "JPEG2000", no_jp2=True)
        data = _patch(buf.getvalue(), _marker(buf.getvalue(), 0x51) + 40,
                      b"\x1f")
    with pytest.raises(ValueError, match=message):
        jpeg2000.decode(data)
    if name in _PIL_REFUSES:
        with pytest.raises(Exception):
            regen.pil_rgb(data)


_PART15 = {"rsiz-0x4000": dict(), "rsiz-0x4001": dict(rsiz=0x4001),
           "rsiz-0x4002": dict(rsiz=0x4002),
           "cap": dict(segments=regen.CAP),
           "cap-cpf": dict(segments=regen.CAP + regen.CPF)}


@pytest.mark.parametrize("name", list(_PART15))
def test_part15_signalling_like_pil(name):
    """Part 15 signalling over Part 1 code-blocks, once refused: Rsiz with
    bit 14 set, a CAP segment (Pcap 0x00020000) and CAP with CPF after
    SIZ. OpenJPEG picks HT decoding by each code-block's style, so PIL
    decodes these to the unpatched stream's pixels, and so does the port;
    Part 1 data under the HT style is refused (``style-ht``)."""
    base = _base_stream()
    data = regen.part15(base, **_PART15[name])
    want = regen.pil_rgb(base)
    np.testing.assert_array_equal(regen.pil_rgb(data), want)
    np.testing.assert_array_equal(jpeg2000.decode(data), want)


def test_part15_svs_read_region_equals_jax_reader(tmp_path):
    """An Aperio SVS whose 33005 tiles carry Rsiz 0x4000 and a CAP
    segment: the port's ``TiffSlide`` reads what the JAX reader (PIL)
    reads, at both levels and across tile edges."""
    from classpose_tpu.io.tiff_reader import TiffSlide as JaxTiffSlide
    from classpose_tpu_torch.io import TiffSlide

    rgb = regen.image(300, 260, 3, seed=21)
    path = tmp_path / "part15.svs"
    streams = regen.write_j2k_tiff(
        path, rgb, tile=128, mpp=0.5, n_levels=2,
        encode_tile=lambda k, c: regen.part15(
            regen.encode(c, "RGB", irreversible=True, mct=1), regen.CAP))
    assert all(st[6:8] == b"\x40\x00" and regen.CAP in st
               for st in streams)
    ours, ref = TiffSlide(str(path)), JaxTiffSlide(str(path))
    try:
        assert ours.level_dimensions == ref.level_dimensions
        for level, loc, size in ((0, (0, 0), (260, 300)),
                                 (0, (100, 90), (70, 80)),
                                 (1, (0, 0), (130, 150))):
            np.testing.assert_array_equal(
                ours.read_region(loc, level, size),
                np.asarray(ref.read_region(loc, level, size)))
    finally:
        ours.close()
        ref.close()


def test_patched_subsampling_like_pil():
    """SIZ's XRsiz and YRsiz of Cb patched to 2 over data coded at full
    size, once refused: PIL reads it by its subsampling rule (Cb's plane
    read at (y / 2) * (W / 2) + x / 2, the image as sYCC), and so does
    the port (``tests/test_torch_jpeg2000_sub.py`` holds genuinely
    subsampled streams)."""
    base = _base_stream()
    data = _patch(base, _marker(base, 0x51) + 44, b"\x02\x02")
    _assert_like_pil(data)


def test_refuses_position_order_with_31_bit_positions():
    """RPCL with 16 decomposition levels and 2^15 precincts: OpenJPEG
    skips such precincts, this decoder refuses the stream."""
    base = _stream(3, 37, 45, "L", False, num_resolutions=1)
    cod = _cod_at(base)
    qcd = _marker(base, 0x5C)
    n = struct.unpack(">H", base[qcd + 2:qcd + 4])[0]
    qcd_seg = (b"\xff\x5c" + struct.pack(">H", 3 + 49)
               + bytes([base[qcd + 4]]) + bytes([8 << 3] * 49))
    data = base[:qcd] + qcd_seg + base[qcd + 2 + n:]
    data = _patch(data, cod + 5, b"\x02")   # RPCL
    data = _patch(data, cod + 9, b"\x10")   # 16 levels
    with pytest.raises(ValueError, match="position-driven progression"):
        jpeg2000.decode(data)


def test_refuses_huge_image():
    base = _base_stream()
    siz = _marker(base, 0x51)
    data = _patch(base, siz + 6, struct.pack(">II", 1 << 20, 1 << 20))
    with pytest.raises(ValueError, match="larger than"):
        jpeg2000.info(data)


def test_refuses_what_is_not_a_codestream():
    with pytest.raises(ValueError, match="no SOC"):
        jpeg2000.decode((GOLDEN / "jpeg_golden.jpg").read_bytes())
    with pytest.raises(ValueError):
        jpeg2000.decode(b"")


# ----------------------------------------------------- corrupt input

@functools.cache
def _fuzz_streams():
    with tempfile.TemporaryDirectory() as tmp:
        return [
            _stream(5, 37, 45, "RGB", False, mct=1, quality_layers=[20, 5],
                    tile_size=(32, 32), precinct_size=(16, 16),
                    progression="RPCL", num_resolutions=3),
            _stream(6, 40, 33, "RGBA", True, quality_layers=[15],
                    codeblock_size=(8, 8)),
            _opj_stream(7, 3, Path(tmp) / "a.j2k", irreversible=True,
                        mode=63, csty=6, roi=(1, 3)),
            _opj_stream(8, 3, Path(tmp) / "b.j2k", mode=5, poc=[
                (0, 0, 1, 3, 3, 0), (0, 0, 2, 3, 3, 2)])]


@settings(max_examples=150, deadline=None)
@given(which=st.integers(0, 3), frac=st.floats(0, 1, exclude_max=True))
def test_truncated_streams_raise(which, frac):
    data = _fuzz_streams()[which]
    with pytest.raises(ValueError):
        jpeg2000.decode(data[:int(frac * len(data))])


@settings(max_examples=250, deadline=None)
@given(which=st.integers(0, 3),
       edits=st.lists(st.tuples(st.floats(0, 1, exclude_max=True),
                                st.integers(0, 255)), min_size=1,
                      max_size=4))
def test_corrupted_streams_raise_or_decode(which, edits):
    """Bytes changed anywhere after SIZ (whose sizes would ask for a large
    image: ``test_refuses_huge_image``): a ``ValueError`` or an image of
    the stream's size, never a crash."""
    data = bytearray(_fuzz_streams()[which])
    start = _marker(bytes(data), 0x51) + 2 + 38 + 3 * 4
    for frac, value in edits:
        data[start + int(frac * (len(data) - start))] = value
    try:
        h, w, _ = jpeg2000.info(bytes(data))
        out = jpeg2000.decode(bytes(data))
    except ValueError:
        return
    assert out.shape == (h, w, 3)
