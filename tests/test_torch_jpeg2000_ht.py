"""HT code-blocks (ITU-T T.814 | ISO/IEC 15444-15, Part 15) in the port's
JPEG 2000 decoder (``classpose_tpu_torch/io/jpeg2000.py`` on
``native/jpeg2000.cpp``) against PIL 12.1 / OpenJPEG 2.5.4, bit for bit
(uint8 equality), on streams that ``tests/golden/htj2k.py`` writes (no
other encoder the tests have writes HT code-blocks):

- lossless streams first: PIL must give back their source samples, which
  checks the writer (its VLC tables, MEL, U-VLC, MagSgn, tier 2) without
  the port; then the port must give PIL's pixels;
- 48 seeded random streams over one to four components, precisions 8 to
  16, both wavelets, code-blocks 4 to 64 on a side, 0 to 5 levels,
  tiles at offsets, one to three layers, truncated blocks with their
  SigProp and MagRef passes, the vertically causal style;
- the committed ``j2k_ht_*`` goldens and ``j2k_ht_region.svs``'s tiles
  against the hashes of PIL's pixels, and the refused goldens by name;
- what OpenJPEG does beyond the standard: a refinement segment begun in
  a later layer than its cleanup pass read into the cleanup's segment,
  the Part 1 style bits beside HT, a fourth pass refused;
- damaged copies: both raise (the port a ``ValueError``) or both give
  the same pixels;
- four threads decoding the goldens as one does;
- the JAX ``main`` (PIL decodes the tiles) against the port's on the HT
  SVS's first row of tiles: the same cells.

PIL is used here only; the port never imports it."""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from classpose_tpu_torch.io import jpeg2000
from golden import htj2k
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


def _assert_like_pil(data, refusal=None):
    """The port decodes ``data`` to PIL's pixels, or raises a ValueError
    (naming ``refusal``) where PIL raises."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError, match=refusal):
            jpeg2000.decode(data)
        return
    got = jpeg2000.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), (
        f"max |diff| {np.abs(got.astype(int) - want).max()}, "
        f"{(got != want).any(-1).mean():.4%} of pixels off")


def _source(h, w, nc, prec, seed):
    img = regen.image(h, w, nc, seed).astype(np.int64)
    rng = np.random.default_rng(seed + 7)
    if prec > 8:
        img = (img << (prec - 8)) | rng.integers(0, 1 << (prec - 8),
                                                 img.shape)
    return img if nc > 1 else img[..., 0]


# ------------------------------------------------------------ lossless

LOSSLESS = [  # (h, w, components, precision, levels, code-block, options)
    (16, 16, 1, 8, 0, (4, 4), {}),
    (1, 1, 1, 8, 0, (6, 6), {}),
    (2, 6, 1, 8, 0, (2, 2), {}),      # a lone last quad in each row
    (5, 5, 1, 8, 0, (2, 2), {}),      # and an odd last row
    (61, 70, 3, 8, 5, (6, 6), {}),
    (37, 45, 3, 8, 3, (2, 6), {}),
    (29, 37, 1, 12, 2, (5, 2), {}),
    (33, 45, 4, 16, 4, (4, 5), {}),
    (50, 45, 3, 8, 2, (4, 4), dict(tile=(24, 20), origin=(5, 3),
                                   tile_origin=(2, 1))),
    (67, 19, 3, 12, 3, (4, 2), dict(tile=(37, 34), origin=(3, 5),
                                    tile_origin=(1, 2))),
    (1, 4, 1, 8, 2, (2, 2), dict(origin=(0, 3))),  # resolutions empty
    (40, 33, 1, 16, 1, (3, 3), dict(nlayers=3, plan=htj2k.Plan(
        layers=lambda rng, n, nl: [int(rng.integers(0, nl))] * n))),
]


@pytest.mark.parametrize("case", LOSSLESS, ids=[
    f"{h}x{w}x{nc}_p{p}_nl{nl}_cb{cb[0]}{cb[1]}" for h, w, nc, p, nl, cb, _
    in LOSSLESS])
def test_lossless_streams_decode_to_their_source(case):
    """PIL decodes the writer's lossless stream to its source (to what it
    gives for OpenJPEG's own lossless stream of it, above 8 bits), and
    the port to PIL's pixels."""
    h, w, nc, prec, nl, cb, kw = case
    img = _source(h, w, nc, prec, seed=h + w)
    data = htj2k.encode(img, prec=prec, nl=nl, cblk=cb, **kw)
    if prec == 8:
        want = np.repeat(img[..., None], 3, -1) if nc == 1 else img[..., :3]
    else:
        want = regen.pil_rgb(regen._opj(img, prec=prec, numres=1,
                                        mct=int(nc >= 3)))
    np.testing.assert_array_equal(regen.pil_rgb(data), want)
    _assert_like_pil(data)


# ------------------------------------------------------------- random

def random_stream(seed):
    """A seeded random HT stream over the goldens' parameters; one in ten
    with each block's passes in layers of their own draw."""
    rng = np.random.default_rng(1000 + seed)
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    nc = int(rng.choice([1, 3, 4]))
    prec = int(rng.choice([8, 12, 16]))
    cb = (int(rng.integers(2, 7)), int(rng.integers(2, 7)))
    if cb[0] + cb[1] > 12:
        cb = (6, 6)
    kw = dict(prec=prec, nl=int(rng.integers(0, 6)), cblk=cb,
              rev=bool(rng.random() < 0.5),
              causal=bool(rng.random() < 0.3),
              nlayers=int(rng.integers(1, 4)), seed=seed)
    if rng.random() < 0.8:
        kw["plan"] = htj2k.random_plan(split=float(rng.random() < 0.1))
    if not kw["rev"]:
        kw["step_shift"] = int(rng.integers(0, 3))
    if rng.random() < 0.3:
        kw.update(tile=(int(rng.integers(8, 40)), int(rng.integers(8, 40))),
                  origin=(3, 5), tile_origin=(1, 2))
    return htj2k.encode(_source(h, w, nc, prec, seed), **kw)


@pytest.mark.parametrize("seed", range(48))
def test_random_streams_like_pil(seed):
    _assert_like_pil(random_stream(seed))


# ------------------------------------------------ OpenJPEG's own rules

def _layers(*split):
    return htj2k.Plan(plane=lambda rng, mb, bits: min(2, bits - 1),
                      passes=lambda rng, p: 3,
                      layers=lambda rng, n, nl: list(split)[:n])


@pytest.mark.parametrize("split", [(0, 0, 0), (0, 0, 1), (1, 1, 2),
                                   (0, 1, 1), (0, 1, 2), (0, 2, 2)])
def test_layers_like_pil(split):
    """The refinement segment in the cleanup's layer, MagRef in a later
    one, and a refinement begun in a later layer (OpenJPEG reads that
    into the cleanup's segment: PIL fails or misreads the block; the port
    does the same)."""
    img = regen.image(40, 40, 3, seed=5)
    data = htj2k.encode(img, nl=1, cblk=(3, 3), nlayers=3,
                        plan=_layers(*split))
    _assert_like_pil(data)
    assert (_pil(data) is not None) == (split[1] == split[0])


@pytest.mark.parametrize("style", [0x41, 0x42, 0x44, 0x48, 0x50, 0x60, 0x7F,
                                   0x80, 0xC0, 0xC8])
def test_style_bits_like_pil(style):
    """Part 1's style bits beside HT change only the codeword segments'
    capacities (termination on each pass: MagRef of a later layer then
    lands in a third segment, which OpenJPEG does not decode); the mixed
    HT bit is refused, as PIL refuses it."""
    img = regen.image(29, 37, 3, seed=6)
    data = bytearray(htj2k.encode(img, rev=False, nl=2, cblk=(4, 4),
                                  nlayers=2, plan=htj2k.random_plan(),
                                  seed=style))
    data[data.index(b"\xff\x52") + 12] = style
    _assert_like_pil(bytes(data), "mixed HT" if style & 0x80 else None)


# -------------------------------------------------------------- goldens

@pytest.mark.parametrize("name", list(_GOLDEN["ht_streams"]))
def test_ht_golden(name):
    """The committed stream decodes to PIL's pixels, and PIL still decodes
    it so (the hash ``chip_smoke.py`` checks on the card)."""
    data = (GOLDEN / name).read_bytes()
    want = _GOLDEN["ht_streams"][name]
    got = jpeg2000.decode(data)
    assert list(got.shape) == want["shape"]
    assert regen.sha256(got) == want["sha256"]
    assert regen.sha256(regen.pil_rgb(data)) == want["sha256"]


@pytest.mark.parametrize("name", list(_GOLDEN["ht_refused"]))
def test_ht_refused_golden(name):
    data = (GOLDEN / name).read_bytes()
    with pytest.raises(ValueError, match=_GOLDEN["ht_refused"][name]):
        jpeg2000.decode(data)
    assert _pil(data) is None


def test_ht_goldens_are_what_the_generator_writes():
    """``regenerate_j2k`` still writes the committed streams byte for
    byte; the lossless ones decode in PIL to their sources."""
    streams = dict(regen.ht_streams())
    refused = regen.ht_refused_streams()
    streams.update({k: v for k, (v, _) in refused.items()})
    assert sorted(streams) == sorted(list(_GOLDEN["ht_streams"])
                                     + list(_GOLDEN["ht_refused"]))
    for name, data in streams.items():
        assert (GOLDEN / name).read_bytes() == data, name
    assert {k: w for k, (_, w) in refused.items()} == _GOLDEN["ht_refused"]
    np.testing.assert_array_equal(
        regen.pil_rgb(streams["j2k_ht_lossless_rgb.j2k"]),
        regen.image(61, 70, 3, seed=70))


def test_ht_golden_svs():
    """``j2k_ht_region.svs``: 16 tiles of 512² at compression 33005,
    lossless 5/3 HT, each decoding to PIL's hash; its level 0 is the
    slide's region exactly; under 4 MB, the small goldens under 150 KB."""
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.io.array_reader import synthetic_wsi

    path = GOLDEN / regen.HT_SVS_NAME
    s = TiffSlide(str(path))
    try:
        p = s._levels[0]
        assert (p.compression, p.tile_width) == (33005, regen.SVS_TILE)
        raw = path.read_bytes()
        streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
        assert len(streams) == len(_GOLDEN["ht_svs"]["tiles"]) == 16
        for data, h in zip(streams, _GOLDEN["ht_svs"]["tiles"]):
            cod = data.index(b"\xff\x52")
            assert data[cod + 12] == 0x40 and data[cod + 13] == 1
            assert regen.sha256(jpeg2000.decode(data)) == h
        region = s.read_region((0, 0), 0, (regen.SVS_REGION,) * 2)[..., :3]
    finally:
        s.close()
    slide, _ = synthetic_wsi(**regen.SLIDE)
    side = regen.SVS_REGION
    np.testing.assert_array_equal(region, slide._level0[:side, :side])
    small = sum((GOLDEN / n).stat().st_size for n in
                list(_GOLDEN["ht_streams"]) + list(_GOLDEN["ht_refused"]))
    assert small < 150_000 and path.stat().st_size < 4_000_000


def test_threads_agree():
    """The HT decoder keeps no shared state (its tables are built once):
    the goldens decoded on four threads equal the serial decodes."""
    streams = [(GOLDEN / n).read_bytes() for n in _GOLDEN["ht_streams"]]
    serial = [jpeg2000.decode(st) for st in streams]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(jpeg2000.decode, streams * 3))
    for k, got in enumerate(threaded):
        np.testing.assert_array_equal(got, serial[k % len(streams)])


# ------------------------------------------------------------- damage

def _damaged(data, seed):
    """Thirty copies of ``data``: one to five bits flipped, a cut, or a
    run of 0xFF bytes, past the main header."""
    rng = np.random.default_rng(seed)
    sod = data.index(b"\xff\x93") + 2
    for k in range(30):
        d = bytearray(data)
        if k % 3 == 0:
            for _ in range(int(rng.integers(1, 6))):
                i = int(rng.integers(sod, len(d)))
                d[i] ^= 1 << int(rng.integers(0, 8))
        elif k % 3 == 1:
            d = d[:int(rng.integers(sod, len(d)))]
        else:
            i, n = int(rng.integers(sod, len(d) - 1)), int(rng.integers(1, 4))
            d[i:i + n] = b"\xff" * len(d[i:i + n])
        yield bytes(d)


@pytest.mark.parametrize("name", [n for n in _GOLDEN["ht_streams"]
                                  if n.endswith(".j2k")])
def test_damaged_streams_like_pil(name):
    """Damaged copies of a golden: where PIL raises, the port raises a
    ``ValueError``; where PIL decodes, the port gives its pixels
    (OpenJPEG's readers, stuffing and malformed-block rules)."""
    for k, data in enumerate(_damaged((GOLDEN / name).read_bytes(),
                                      len(name))):
        want = _pil(data)
        try:
            got = jpeg2000.decode(data)
        except ValueError:
            assert want is None, f"copy {k}: PIL decodes, the port raises"
            continue
        assert want is not None, f"copy {k}: PIL raises, the port decodes"
        assert np.array_equal(got, want), f"copy {k} decodes unlike PIL"


# ------------------------------------------------- the CLI, JAX and port

@pytest.fixture(scope="module")
def ht_runs(tmp_path_factory):
    """JAX ``main`` (``WSI_READER=tiff``: PIL decodes the tiles) and the
    port's (``WSI_READER`` unset) on the HT SVS's first row of tiles as a
    2048 × 512 SVS."""
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.io import TiffSlide
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from test_torch_pipeline import CFG, LABELS, _args

    tmp = tmp_path_factory.mktemp("wsi_j2k_ht")
    path = GOLDEN / regen.HT_SVS_NAME
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


def test_ht_slide_same_tiles_and_cells(ht_runs):
    """Both readers give the same pixels: the same tiles and cells, every
    port cell on a JAX cell of the same class (sorted: the reader threads
    finish in either order)."""
    from test_torch_pipeline import _centroids

    tmp, ref, got = ht_runs
    assert got["n_tiles"] == ref["n_tiles"] == 8
    assert ref["n_cells"] >= 100 and got["n_cells"] == ref["n_cells"]
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    ref_order, order = np.lexsort(ref_pts.T), np.lexsort(pts.T)
    np.testing.assert_allclose(pts[order], ref_pts[ref_order], atol=1e-3)
    assert [names[i] for i in order] == [ref_names[i] for i in ref_order]
