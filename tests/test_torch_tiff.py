"""The port's slide I/O against PIL and the JAX package: the native JPEG
decoder bit for bit against PIL (libjpeg-turbo) on the baseline streams
a slide carries (the other processes: ``test_torch_jpeg_processes.py``),
the encoder against PIL's own streams, and the
port's ``TiffSlide`` bit for bit against the JAX ``TiffSlide`` on every
file the JAX I/O tests build, on Aperio JPEG 2000 pyramids (33003 and
33005, 240² tiles with partial edge tiles), plus hand-made files for what
those leave out (big-endian, the horizontal predictor, classic tiled
pages).

PIL is used here only, to make and decode reference streams; the port
never imports it."""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from classpose_tpu.io.tiff_reader import TiffSlide as JaxTiffSlide
from classpose_tpu.io.tiff_writer import write_tiled_tiff as jax_write
from classpose_tpu.utils import get_slide_resolution as jax_resolution
from classpose_tpu_torch.io import jpeg
from classpose_tpu_torch.io.tiff_reader import TiffSlide
from classpose_tpu_torch.io.tiff_writer import write_tiled_tiff
from classpose_tpu_torch.utils import get_slide_resolution
from golden import regenerate_j2k as regen_j2k

GOLDEN = Path(__file__).parent / "golden"


def _image(h, w, seed=0, noise=14.0):
    """Smooth colour ramps plus noise: every block has AC terms, and the
    chroma planes vary, so upsampling shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 90 * np.sin(xx / 5.0 + yy / 9.0),
                    60 + (3 * yy) % 160, 220 - (2 * xx) % 180], -1)
    return np.clip(img + rng.normal(0, noise, img.shape), 0,
                   255).astype(np.uint8)


def _pil_jpeg(img, mode=None, **kw):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# ------------------------------------------------------------ decoder

@pytest.mark.parametrize("size", [(1, 1), (8, 8), (17, 33), (37, 53),
                                  (255, 257)])
@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_decoder_equals_pil(size, quality, subsampling):
    data = _pil_jpeg(_image(*size), quality=quality,
                     subsampling=subsampling)
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("quality", [50, 95])
def test_decoder_grayscale(quality):
    data = _pil_jpeg(_image(37, 53)[..., 1], "L", quality=quality)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    assert Image.open(io.BytesIO(data)).mode == "L"
    got = jpeg.decode(data)
    assert jpeg.info(data) == (37, 53, 1)
    for c in range(3):
        np.testing.assert_array_equal(got[..., c], ref)


@pytest.mark.parametrize("kw", [
    dict(restart_marker_blocks=3),
    dict(restart_marker_rows=1),
    dict(restart_marker_blocks=1, subsampling=0),
], ids=["blocks3", "rows1", "blocks1-444"])
def test_decoder_restart_intervals(kw):
    data = _pil_jpeg(_image(37, 53), quality=80, **kw)
    assert b"\xff\xdd" in data  # DRI
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("quality", [50, 90])
def test_decoder_adobe_rgb_without_transform(quality):
    """``keep_rgb`` (4:4:4 only in PIL): an Adobe APP14 with transform 0,
    components 'R','G','B': no colour conversion (libjpeg's rule)."""
    data = _pil_jpeg(_image(37, 53), quality=quality, keep_rgb=True)
    assert b"Adobe" in data
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))


def _tiff_strips(path):
    """(JPEGTables, first strip) of a striped JPEG TIFF, read with
    PIL's tag parser."""
    im = Image.open(path)
    tags = im.tag_v2
    with open(path, "rb") as f:
        f.seek(tags[273][0])
        strip = f.read(tags[279][0])
    return tags[347], strip


def test_decoder_abbreviated_stream_with_tiff_tables(tmp_path):
    """libtiff's JPEG TIFF: tables in the page's JPEGTables, abbreviated
    strip streams, components 'R','G','B' with no JFIF or Adobe marker."""
    from classpose_tpu.io.tiff_reader import _merge_jpeg_tables

    from classpose_tpu_torch.io.tiff_reader import (
        _merge_jpeg_tables as port_merge,
    )

    img = _image(64, 96)
    path = tmp_path / "strips.tif"
    Image.fromarray(img).save(path, format="TIFF", compression="jpeg",
                              quality=85)
    tables, strip = _tiff_strips(path)
    assert b"\xff\xdb" not in strip  # abbreviated: no tables of its own
    stream = port_merge(tables, strip)
    assert stream == _merge_jpeg_tables(tables, strip)
    assert b"JFIF" not in stream and b"Adobe" not in stream
    np.testing.assert_array_equal(jpeg.decode(stream), _pil_rgb(stream))


def test_decoder_refuses_progressive():
    """The decoder once refused progressive streams; it reads SOF2 now as
    PIL does, and refuses the hierarchical (differential) progressive
    process SOF6, which PIL refuses too."""
    data = _pil_jpeg(_image(37, 53), quality=80, progressive=True)
    np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
    sof6 = bytearray(data)
    sof6[data.index(b"\xff\xc2") + 1] = 0xC6
    with pytest.raises(Exception):
        _pil_rgb(bytes(sof6))
    with pytest.raises(ValueError, match="SOF6"):
        jpeg.decode(bytes(sof6))


def test_decoder_refuses_what_is_not_jpeg():
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode(b"not a jpeg")
    data = _pil_jpeg(_image(16, 16), quality=80)
    with pytest.raises(ValueError):
        jpeg.decode(data[:200])  # cut before the scan


def test_decoder_golden():
    """The committed golden pair (``tests/golden/regenerate_jpeg.py``):
    what ``chip_smoke.py`` checks on the card's machine, where PIL is
    absent."""
    data = (GOLDEN / "jpeg_golden.jpg").read_bytes()
    ref = np.load(GOLDEN / "jpeg_golden_rgb.npy")
    np.testing.assert_array_equal(jpeg.decode(data), ref)
    np.testing.assert_array_equal(ref, _pil_rgb(data))


# ------------------------------------------------------------ encoder

def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (64, 64), (255, 257)])
@pytest.mark.parametrize("quality", [50, 80, 95])
def test_encoder_streams_decode_alike(size, quality):
    """PIL and the port decode the port's stream to the same pixels, and
    its PSNR against the source is within 0.5 dB of PIL's own stream."""
    img = _image(*size, seed=3)
    ours = jpeg.encode(img, quality)
    got = jpeg.decode(ours)
    np.testing.assert_array_equal(got, _pil_rgb(ours))
    if size != (1, 1):
        pil = _pil_rgb(_pil_jpeg(img, quality=quality))
        assert abs(_psnr(got, img) - _psnr(pil, img)) <= 0.5


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (256, 256)])
def test_encoder_writes_pils_stream(size):
    """With libjpeg's defaults (4:2:0, islow DCT, reciprocal quantization,
    standard Huffman tables), byte for byte what PIL writes."""
    img = _image(*size, seed=4)
    for quality in (50, 80, 95, 100):
        assert jpeg.encode(img, quality) == _pil_jpeg(img, quality=quality)


# ---------------------------------------------------- reader parity

def _write_pil_pyramid(path, base, compression=None):
    """``tests/test_io.py``'s PIL pyramid: three pages, 2 px/cm."""
    imgs = [Image.fromarray(base)]
    lvl = base
    for _ in range(2):
        lvl = lvl[::2, ::2]
        imgs.append(Image.fromarray(lvl))
    kw = {"compression": compression} if compression else {}
    imgs[0].save(path, format="TIFF", save_all=True, append_images=imgs[1:],
                 resolution=2.0, resolution_unit="cm", **kw)


def _write_minimal_bigtiff(path, img):
    """``tests/test_io.py``'s hand-made little-endian BigTIFF: one
    uncompressed strip, XResolution as a SHORT."""
    H, W, _ = img.shape
    data = img.tobytes()

    def entry(tag, type_, count, value):
        return struct.pack("<HHQQ", tag, type_, count, value)

    data_offset = 16 + 8 + 11 * 20 + 8
    bps_offset = data_offset + len(data)
    entries = [entry(256, 4, 1, W), entry(257, 4, 1, H),
               entry(258, 3, 3, bps_offset), entry(259, 3, 1, 1),
               entry(262, 3, 1, 2), entry(273, 16, 1, data_offset),
               entry(277, 3, 1, 3), entry(278, 4, 1, H),
               entry(279, 16, 1, len(data)), entry(282, 3, 1, 72),
               entry(296, 3, 1, 2)]
    with open(path, "wb") as f:
        f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 16))
        f.write(struct.pack("<Q", len(entries)) + b"".join(entries)
                + struct.pack("<Q", 0))
        f.write(data)
        f.write(struct.pack("<HHH", 8, 8, 8))


def _write_handmade(path, img, order, big, tile, compression, predictor):
    """One RGB page in either byte order, classic or BigTIFF, tiled
    (``tile`` px) or in 7-row strips, uncompressed or Deflate, with or
    without the horizontal predictor."""
    e = "<" if order == b"II" else ">"
    H, W, _ = img.shape
    if tile:
        chunks = []
        for ty in range(0, H, tile):
            for tx in range(0, W, tile):
                t = np.zeros((tile, tile, 3), np.uint8)
                part = img[ty:ty + tile, tx:tx + tile]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(t)
    else:
        chunks = [img[y:y + 7] for y in range(0, H, 7)]
    blobs = []
    for c in chunks:
        if predictor == 2:
            c = c.astype(np.int16)
            c = np.concatenate([c[:, :1], np.diff(c, axis=1)], 1) % 256
            c = c.astype(np.uint8)
        raw = np.ascontiguousarray(c).tobytes()
        blobs.append(zlib.compress(raw) if compression == 8 else raw)
    off_t, off_fmt = (16, "Q") if big else (4, "I")
    head = 16 if big else 8
    pos = head
    offsets = []
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    arrays_at = pos
    offs_bytes = struct.pack(e + off_fmt * len(offsets), *offsets)
    cnts_bytes = struct.pack(e + off_fmt * len(blobs),
                             *[len(b) for b in blobs])
    bps_bytes = struct.pack(e + "HHH", 8, 8, 8)
    res_bytes = struct.pack(e + "II", 20000, 1)  # 20000 px/cm: 0.5 µm/px
    extra = [offs_bytes, cnts_bytes, bps_bytes, res_bytes]
    extra_at = []
    for blob in extra:
        extra_at.append(pos)
        pos += len(blob)
    ifd_at = pos
    tags = [(256, 4, 1, W), (257, 4, 1, H), (258, 3, 3, extra_at[2]),
            (259, 3, 1, compression), (262, 3, 1, 2), (277, 3, 1, 3),
            (282, 5, 1, extra_at[3]), (296, 3, 1, 3),
            (317, 3, 1, predictor)]
    if tile:
        tags += [(322, 3, 1, tile), (323, 3, 1, tile),
                 (324, off_t, len(blobs), extra_at[0]),
                 (325, off_t, len(blobs), extra_at[1])]
    else:
        tags += [(273, off_t, len(blobs), extra_at[0]), (278, 3, 1, 7),
                 (279, off_t, len(blobs), extra_at[1])]
    tags.sort()
    ifd = b""
    slot = 8 if big else 4
    for tag, type_, count, value in tags:
        # a value that fits is left-justified in the entry's slot; else
        # the slot holds the offset of the value
        fmt = {3: "H", 4: "I", 16: "Q"}[type_] if count == 1 and type_ != 5 \
            else off_fmt
        inline = struct.pack(e + fmt, value)
        if big and type_ == 5:  # a rational fits BigTIFF's 8-byte slot
            inline = res_bytes
        ifd += (struct.pack(e + ("HHQ" if big else "HHI"), tag, type_, count)
                + inline + b"\0" * (slot - len(inline)))
    with open(path, "wb") as f:
        if big:
            f.write(order + struct.pack(e + "HHHQ", 43, 8, 0, ifd_at))
        else:
            f.write(order + struct.pack(e + "HI", 42, ifd_at))
        for b in blobs + extra:
            f.write(b)
        assert f.tell() == ifd_at
        f.write(struct.pack(e + ("Q" if big else "H"), len(tags)) + ifd
                + struct.pack(e + ("Q" if big else "I"), 0))


def _base(h=300, w=400, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3),
                                                dtype=np.uint8)


def _file(kind, tmp_path):
    path = tmp_path / f"{kind}.tif"
    if kind.startswith("pil-"):
        comp = kind[4:]
        _write_pil_pyramid(path, _base(), None if comp == "raw" else comp)
    elif kind == "jpeg-strips":
        base = np.random.default_rng(1).integers(100, 140, (128, 128, 3),
                                                 dtype=np.uint8)
        Image.fromarray(base).save(path, format="TIFF", compression="jpeg",
                                   quality=95)
    elif kind == "bigtiff":
        _write_minimal_bigtiff(path, _base(60, 80, 7))
    elif kind in ("jax-writer", "port-writer"):
        write = jax_write if kind == "jax-writer" else write_tiled_tiff
        path = write(path, _image(700, 1100, seed=5), tile=256, quality=92,
                     mpp=0.5)
    elif kind.startswith("j2k-"):
        # Aperio's 9/7 tiles: RGB with the ICT (33005), or the YCbCr
        # values as plain components (33003)
        comp = int(kind[4:])
        regen_j2k.write_j2k_tiff(path, _image(300, 400, seed=3), tile=240,
                                 mpp=0.5, compression=comp, n_levels=3,
                                 irreversible=True, quality_layers=[12],
                                 mct=int(comp == 33005))
    else:  # hand-made: order-big-tile-compression-predictor
        order, big, tile, comp, pred = kind.split("-")
        _write_handmade(path, _base(150, 130, 2), order.encode(),
                        big == "big", int(tile), int(comp), int(pred))
    return str(path)


FILES = ["pil-raw", "pil-tiff_adobe_deflate", "pil-tiff_lzw", "jpeg-strips",
         "bigtiff", "jax-writer", "port-writer", "j2k-33003", "j2k-33005",
         "MM-classic-0-1-1", "MM-big-64-8-2", "II-classic-64-8-2",
         "MM-classic-0-8-2"]
WINDOWS = [  # (level, level-0 location, size)
    (0, (0, 0), (64, 48)),        # aligned
    (0, (37, 21), (90, 70)),      # unaligned, crossing tiles and strips
    (0, (250, 5), (300, 260)),    # past the right and bottom edges
    (0, (-20, -9), (50, 40)),     # before the top-left corner
    (0, (5000, 5000), (16, 16)),  # wholly outside
    (1, (0, 0), (64, 64)),
    (1, (90, 70), (150, 128)),
    (1, (-30, 150), (120, 200)),
]


@pytest.mark.parametrize("kind", FILES)
def test_reader_equals_jax_reader(kind, tmp_path):
    path = _file(kind, tmp_path)
    ours, ref = TiffSlide(path), JaxTiffSlide(path)
    try:
        assert ours.level_count == ref.level_count
        assert ours.level_dimensions == ref.level_dimensions
        assert ours.dimensions == ref.dimensions
        assert ours.level_downsamples == ref.level_downsamples
        assert ours.properties == ref.properties
        for ds in (0.5, 1.0, 1.9, 2.0, 3.0, 4.0, 100.0):
            assert (ours.get_best_level_for_downsample(ds)
                    == ref.get_best_level_for_downsample(ds))
        assert get_slide_resolution(ours) == jax_resolution(ref)
        for level, loc, size in WINDOWS:
            if level >= ref.level_count:
                continue
            got = ours.read_region(loc, level, size)
            want = np.asarray(ref.read_region(loc, level, size))
            assert isinstance(got, np.ndarray) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{level} {loc} {size}")
    finally:
        ours.close()
        ref.close()


def test_handmade_files_hold_their_pixels(tmp_path):
    """The hand-made files are what they claim: both byte orders, the
    predictor and Deflate decode to the source pixels."""
    base = _base(150, 130, 2)
    for kind in [k for k in FILES if k[:2] in ("II", "MM")]:
        s = TiffSlide(_file(kind, tmp_path))
        np.testing.assert_array_equal(
            s.read_region((0, 0), 0, (130, 150))[..., :3], base)
        assert get_slide_resolution(s) == (0.5, 0.5)
        s.close()


def test_port_writer_pyramid(tmp_path):
    """The port's writer: the JAX writer's layout and defaults, level
    geometry and MPP, JPEG-close pixels, each tile a stream PIL writes
    the same."""
    img = _image(700, 1100, seed=5, noise=0)
    path = write_tiled_tiff(tmp_path / "p.svs", img, tile=256, quality=92,
                            mpp=0.5)
    ref = jax_write(tmp_path / "j.svs", img, tile=256, quality=92, mpp=0.5)
    assert Path(path).read_bytes() == Path(ref).read_bytes()
    s = TiffSlide(str(path))
    assert s.level_count == 2
    assert s.level_dimensions == ((1100, 700), (550, 350))
    assert float(s.properties["openslide.mpp-x"]) == 0.5
    r = s.read_region((300, 100), 0, (256, 200))[..., :3]
    assert np.abs(r.astype(int) - img[100:300, 300:556].astype(int)).mean() \
        < 4.0
    s.close()
    import inspect

    from classpose_tpu.io import tiff_writer as jw
    from classpose_tpu_torch.io import tiff_writer as pw

    assert (inspect.signature(pw.write_tiled_tiff).parameters.keys()
            == inspect.signature(jw.write_tiled_tiff).parameters.keys())
    for name, p in inspect.signature(jw.write_tiled_tiff).parameters.items():
        assert inspect.signature(pw.write_tiled_tiff).parameters[name] \
            .default == p.default, name


def test_reader_thumbnail_subsamples(tmp_path):
    path = _file("pil-raw", tmp_path)
    s = TiffSlide(path)
    lv = s._read_level_region(2, 0, 0, 100, 75)
    th = s.get_thumbnail((40, 40))
    np.testing.assert_array_equal(th, lv[::3, ::3])
    assert max(th.shape[:2]) <= 40
    s.close()


def test_reader_refuses_jpeg2000(tmp_path):
    """A 33003 page whose tile is not a JPEG 2000 codestream: the decoder's
    ``ValueError`` (the reader decodes Aperio JPEG 2000 tiles; the pyramids
    of ``FILES`` hold it bitwise to the JAX reader)."""
    path = tmp_path / "j2k.tif"
    _write_handmade(path, _base(16, 16, 1), b"II", False, 16, 1, 1)
    raw = bytearray(path.read_bytes())
    # rewrite the compression tag's value (1 -> 33003, Aperio JPEG 2000)
    at = raw.index(struct.pack("<HHIH", 259, 3, 1, 1))
    raw[at:at + 10] = struct.pack("<HHIH", 259, 3, 1, 33003)
    path.write_bytes(bytes(raw))
    s = TiffSlide(str(path))
    with pytest.raises(ValueError, match="not a JPEG 2000 codestream"):
        s.read_region((0, 0), 0, (8, 8))
    s.close()
    with pytest.raises(ValueError, match="not a TIFF"):
        TiffSlide(str(GOLDEN / "jpeg_golden.jpg"))


# ------------------------------------------------------------ facade

@pytest.mark.parametrize("value,name", [
    (None, "TiffSlide"), ("openslide", "TiffSlide"), ("tiff", "TiffSlide"),
    ("TIFF", "TiffSlide"), ("array", "ArraySlide"),
])
def test_facade_maps_readers(monkeypatch, value, name):
    from classpose_tpu_torch.io import WSIReader, get_wsi_reader

    if value is None:
        monkeypatch.delenv("WSI_READER", raising=False)
    else:
        monkeypatch.setenv("WSI_READER", value)
    assert get_wsi_reader().__name__ == name
    if name == "TiffSlide":
        with pytest.raises(ValueError, match="not a TIFF"):
            WSIReader(str(GOLDEN / "jpeg_golden.jpg"))


@pytest.mark.parametrize("value", ["czi", "czi-zeiss", "CZI-Zeiss"])
def test_facade_refuses_czi(monkeypatch, value):
    """``czi``/``czi-zeiss`` (any case) select the package's own CZI
    reader, which refuses a file that is not a CZI."""
    from classpose_tpu_torch.io import WSIReader, get_wsi_reader

    monkeypatch.setenv("WSI_READER", value)
    assert get_wsi_reader().__name__ == "CZISlide"
    with pytest.raises(ValueError, match="not a CZI file"):
        WSIReader(str(GOLDEN / "jpeg_golden.jpg"))
