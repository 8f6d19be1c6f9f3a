"""Component subsampling in the port's JPEG 2000 decoder
(``classpose_tpu_torch/io/jpeg2000.py`` on ``native/jpeg2000.cpp``)
against PIL 12.1 / OpenJPEG 2.5.4, bit for bit (uint8 equality), on
streams whose planes OpenJPEG's own encoder wrote at their own sizes
(``regenerate_j2k.opj_encode`` with ``dx``, ``dy``):

- the committed ``j2k_sub_*`` goldens and the refused ones;
- a seeded sweep: one to four components × (XRsiz, YRsiz) in {1, 2, 3,
  4} each × even and odd sizes × the five progressions × both wavelets,
  with precincts in the position-driven orders and tiles at odd sizes
  and offsets; where PIL raises (one or two components with any
  subsampling) the port raises a ``ValueError`` naming component
  subsampling;
- the multiple component transform over components of other sizes
  (PIL raises) and of one size (decoded), and JP2 files whose ``colr``
  names sRGB, sYCC or greyscale;
- the port's ``TiffSlide`` against the JAX reader on a 33003 SVS of
  4:2:0 tiles with odd edge tiles, and JAX ``main`` against the port's on
  it.

PIL is used here only, to make and decode reference streams; the port
never imports it."""

import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from classpose_tpu_torch.io import jpeg2000
from golden import regenerate_j2k as regen
from golden.jax_native import jax_native_geometry  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"
_GOLDEN = json.loads((GOLDEN / regen.JSON_NAME).read_text())


def _pil(data):
    """PIL's pixels, or None where PIL raises."""
    try:
        return regen.pil_rgb(data)
    except Exception:
        return None


def _assert_like_pil(data, refusal="component subsampling"):
    """The port decodes ``data`` to PIL's pixels, or raises naming
    ``refusal`` where PIL raises."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError, match=refusal):
            jpeg2000.decode(data)
        return
    got = jpeg2000.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), (
        f"{(got != want).any(-1).mean():.4%} of pixels off")


# -------------------------------------------------------------- goldens

@pytest.mark.parametrize("name", list(_GOLDEN["sub_streams"]))
def test_sub_golden(name):
    """The committed stream decodes to PIL's pixels, and PIL still decodes
    it so (the hash ``chip_smoke.py`` checks on the card)."""
    data = (GOLDEN / name).read_bytes()
    want = _GOLDEN["sub_streams"][name]
    got = jpeg2000.decode(data)
    assert list(got.shape) == want["shape"]
    assert regen.sha256(got) == want["sha256"]
    assert regen.sha256(regen.pil_rgb(data)) == want["sha256"]


@pytest.mark.parametrize("name", list(_GOLDEN["sub_refused"]))
def test_sub_refused_golden(name):
    data = (GOLDEN / name).read_bytes()
    with pytest.raises(ValueError, match=_GOLDEN["sub_refused"][name]):
        jpeg2000.decode(data)
    assert _pil(data) is None


def test_sub_golden_svs():
    """``j2k_sub_region.svs``: 16 tiles of 512² at compression 33003, the
    chroma subsampled 4:2:0 and 4:2:2 in turn, each decoding to PIL's
    hash; the slide's region within 30 dB (PIL reads them as sYCC); the
    SVS under 256 KiB, the small goldens under 64 KiB."""
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from classpose_tpu_torch.utils import get_slide_resolution

    g = _GOLDEN["sub_svs"]
    path = GOLDEN / regen.SUB_SVS_NAME
    s = TiffSlide(str(path))
    try:
        p = s._levels[0]
        assert s.level_dimensions == ((regen.SVS_REGION,) * 2,)
        assert (p.compression, p.tile_width) == (33003, regen.SVS_TILE)
        assert get_slide_resolution(s) == (regen.SVS_MPP, regen.SVS_MPP)
        raw = path.read_bytes()
        streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
        assert len(streams) == len(g["tiles"]) == 16
        assert g["kinds"] == list(regen.SUB_KINDS)
        for k, (data, h) in enumerate(zip(streams, g["tiles"])):
            siz = data.index(b"\xff\x51") + 40
            dy = 2 if k % 2 == 0 else 1  # 4:2:0, 4:2:2
            assert data[siz:siz + 9] == bytes([7, 1, 1, 7, 2, dy, 7, 2, dy])
            assert regen.sha256(jpeg2000.decode(data)) == h
        region = s.read_region((0, 0), 0, (regen.SVS_REGION,) * 2)[..., :3]
    finally:
        s.close()
    slide, _ = synthetic_wsi(**regen.SLIDE)
    side = regen.SVS_REGION
    mse = np.mean((region.astype(np.float64)
                   - slide._level0[:side, :side]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) > 30
    small = sum((GOLDEN / n).stat().st_size for n in
                list(_GOLDEN["sub_streams"]) + list(_GOLDEN["sub_refused"]))
    assert small < 64 * 1024 and path.stat().st_size < 256 * 1024


def test_sub_goldens_are_what_the_generator_writes():
    """``regenerate_j2k`` still writes the committed streams byte for
    byte, so the sweep's encoder is the goldens'."""
    streams = dict(regen.sub_streams())
    streams.update({k: v for k, (v, _) in
                    regen.sub_refused_streams().items()})
    assert sorted(streams) == sorted(list(_GOLDEN["sub_streams"])
                                     + list(_GOLDEN["sub_refused"]))
    for name, data in streams.items():
        assert (GOLDEN / name).read_bytes() == data, name


# ---------------------------------------------------------------- sweep

_ORDERS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
_SIZES = ((40, 48), (37, 53))  # (height, width): even, odd


def _sweep(nc, order, wavelet):
    """Six seeded streams of ``nc`` components in ``order``: factors in
    {1, 2, 3, 4} per component (component 0 at 1 three times in four, at
    least one component subsampled), both sizes, precincts in the
    position-driven orders, the last two tiled at odd sizes and offsets.
    A draw OpenJPEG's encoder fails on (a tile-component left empty) is
    drawn again."""
    rng = np.random.default_rng([nc, _ORDERS.index(order), wavelet == "97"])
    k = 0
    while k < 6:
        dx = [int(v) for v in rng.integers(1, 5, nc)]
        dy = [int(v) for v in rng.integers(1, 5, nc)]
        if rng.random() < 0.75:
            dx[0] = dy[0] = 1
        if dx == dy == [1] * nc:
            dx[-1] = 2
        h, w = _SIZES[k % 2]
        kw = dict(numres=3, cblk=(8, 8), order=order, dx=dx, dy=dy,
                  irreversible=wavelet == "97", rates=(6, 2)[:1 + k % 2])
        if order in ("RPCL", "PCRL", "CPRL"):
            kw["precincts"] = [(16, 16)] if k % 2 else [(32, 16), (8, 8)]
        if k >= 4:
            kw.update(numres=2, tiles=(23, 19), tile_origin=(1, 2),
                      origin=(3, 5))
        img = regen.image(h, w, nc, seed=int(rng.integers(1 << 30)))
        try:
            data = regen._opj(img, **kw)
        except RuntimeError:
            continue
        k += 1
        yield f"{dx} x {dy} {h}x{w} {kw}", data


@pytest.mark.parametrize("wavelet", ["53", "97"])
@pytest.mark.parametrize("order", _ORDERS)
@pytest.mark.parametrize("nc", [1, 2, 3, 4])
def test_subsampling_sweep_like_pil(nc, order, wavelet):
    for what, data in _sweep(nc, order, wavelet):
        try:
            _assert_like_pil(data)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from e


# ------------------------------------------------------ MCT and JP2

@pytest.mark.parametrize("wavelet", ["53", "97"])
@pytest.mark.parametrize("dx", [(1, 2, 2), (1, 1, 2), (2, 2, 2), (3, 3, 3)])
def test_mct_like_pil(dx, wavelet):
    """The COD's MCT byte set over subsampled components: OpenJPEG fails
    the tile where their sizes differ (PIL raises), and transforms them
    where every component is subsampled alike."""
    data = regen._opj(regen.image(37, 45, 3, seed=sum(dx)), numres=3,
                      dx=dx, dy=dx, irreversible=wavelet == "97")
    cod = data.index(b"\xff\x52")
    data = data[:cod + 8] + b"\x01" + data[cod + 9:]
    if len(set(dx)) > 1:
        assert _pil(data) is None
    _assert_like_pil(data, "components of different sizes")


@pytest.mark.parametrize("space", ["srgb", "sycc", "grey"])
@pytest.mark.parametrize("dx", [(1, 2, 2), (2, 2, 2), (1, 2, 2, 1),
                                (1, 1, 1, 2), (2,)])
def test_jp2_colr_like_pil(space, dx):
    """OpenJPEG's JP2 container over subsampled components: PIL's mode from
    ihdr, the colour space from colr (no guess from the subsampling),
    greyscale with four components read as sRGB with alpha."""
    data = regen._opj(regen.image(37, 45, len(dx), seed=len(dx)), numres=3,
                      dx=dx, dy=dx, codec="jp2", colour_space=space)
    _assert_like_pil(data)


_FUZZED = ("j2k_sub_tiles.j2k", "j2k_sub_pcrl_53.j2k", "j2k_sub_alpha.j2k",
           "j2k_sub_odd.j2k", "j2k_sub_sycc.jp2")


@settings(max_examples=200, deadline=None)
@given(which=st.integers(0, len(_FUZZED) - 1),
       cut=st.floats(0, 1), edits=st.lists(st.tuples(
           st.floats(0, 1, exclude_max=True), st.integers(0, 255)),
           max_size=4))
def test_damaged_streams_raise_or_decode(which, cut, edits):
    """A subsampled golden cut short and bytes changed anywhere (SIZ's
    factors, tile sizes and offsets, packets): a ``ValueError`` or an
    image of the size the header gives, never a crash."""
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


def test_subsampling_zero_is_a_siz_error():
    data = (GOLDEN / "j2k_sub_420.j2k").read_bytes()
    siz = data.index(b"\xff\x51")
    data = data[:siz + 44] + b"\x00" + data[siz + 45:]
    with pytest.raises(ValueError, match="SIZ: component subsampling 0"):
        jpeg2000.decode(data)


# ------------------------------------------- the slide reader and the CLI

# a 33003 pyramid of 4:2:0 tiles of 256² from the slide's top-left
# 555 × 701: its edge tiles coded at their own odd sizes (189 × 43 at
# level 0, 95 × 22 at level 1)
REGION = (555, 701)
WINDOWS = [(0, (0, 0), (701, 555)), (0, (250, 240), (300, 200)),
           (1, (0, 0), (351, 278)), (1, (-20, 100), (200, 200))]


def _sub_tile(k, ycc):
    return regen._opj(ycc, irreversible=True, rates=(20,), numres=3,
                      dx=(1, 2, 2), dy=(1, 2, 2))


@pytest.fixture(scope="module")
def sub_svs(tmp_path_factory):
    from classpose_tpu.io.array_reader import synthetic_wsi

    tmp = tmp_path_factory.mktemp("j2k_sub")
    slide, _ = synthetic_wsi(width=1100, height=900, n_cells=80, seed=4,
                             mpp=0.4)
    level0 = np.ascontiguousarray(slide._level0[:REGION[0], :REGION[1]])
    regen.write_j2k_tiff(tmp / "slide.svs", level0, tile=256, mpp=0.4,
                         compression=33003, n_levels=2, encode_tile=_sub_tile)
    return tmp


def test_svs_tiles_are_subsampled(sub_svs):
    from classpose_tpu_torch.io import TiffSlide

    s = TiffSlide(str(sub_svs / "slide.svs"))
    try:
        p = s._levels[0]
        assert p.compression == 33003 and len(p.offsets) == 9
        raw = (sub_svs / "slide.svs").read_bytes()
        tile = raw[p.offsets[-1]:p.offsets[-1] + p.counts[-1]]
    finally:
        s.close()
    siz = tile.index(b"\xff\x51")
    assert struct.unpack(">II", tile[siz + 6:siz + 14]) == (189, 43)
    assert tile[siz + 40:siz + 49] == bytes([7, 1, 1, 7, 2, 2, 7, 2, 2])


def test_svs_read_region_equals_jax_reader(sub_svs):
    from classpose_tpu.io.tiff_reader import TiffSlide as JaxTiffSlide
    from classpose_tpu_torch.io import TiffSlide

    path = str(sub_svs / "slide.svs")
    ours, ref = TiffSlide(path), JaxTiffSlide(path)
    try:
        assert ours.level_dimensions == ref.level_dimensions
        for level, loc, size in WINDOWS:
            got = ours.read_region(loc, level, size)
            want = np.asarray(ref.read_region(loc, level, size))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{level} {loc} {size}")
    finally:
        ours.close()
        ref.close()


@pytest.fixture(scope="module")
def sub_runs(sub_svs):
    """JAX ``main`` (``WSI_READER=tiff``: PIL decodes the tiles) and the
    port's (``WSI_READER`` unset) on the SVS."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_pipeline import CFG, LABELS, _args

    tmp = sub_svs
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


def test_svs_cli_same_tiles_and_cells(sub_runs):
    """Both readers give the same pixels: the same tiles and cells, every
    port cell on a JAX cell of the same class (sorted: the reader threads
    finish in either order)."""
    from test_torch_pipeline import _centroids

    tmp, ref, got = sub_runs
    assert got["n_tiles"] == ref["n_tiles"] == 2
    assert ref["n_cells"] >= 20 and got["n_cells"] == ref["n_cells"]
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    ref_order, order = np.lexsort(ref_pts.T), np.lexsort(pts.T)
    np.testing.assert_allclose(pts[order], ref_pts[ref_order], atol=1e-3)
    assert [names[i] for i in order] == [ref_names[i] for i in ref_order]
