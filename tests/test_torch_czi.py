"""The port's Zeiss CZI reader (``classpose_tpu_torch/io/czi.py``,
``io/czi_reader.py``) against the JAX package's ``CZISlide``, on the CPU.

pylibCZIrw is on neither machine, so the JAX reader runs over a fake of
``pylibCZIrw.czi`` installed in ``sys.modules``, as
``tests/test_czi_mock.py`` installs its own: :class:`FakeCziReader` below,
a plain reader of the ZISRAW container written with ``struct``,
``zstandard``, PIL and numpy, importing nothing of the port. It models
pylibCZIrw's ``read(roi, zoom)`` as ``tests/test_czi_mock.py`` does:
the plane C = Z = T = 0 of every scene, subblocks drawn in M-index order,
the pyramid layer with the smallest zoom at or above the request (each
stored pixel covering its Size / StoredSize block), the request clamped
to the bounding rectangle, then PIL's ``NEAREST`` to ``round(size *
zoom)``.

- every golden of ``tests/golden/regenerate_czi.py``: ``read_region``
  bitwise against the JAX reader at levels 0-4, on edge requests (which
  the JAX reader resizes with PIL) and inside, against the hashes in
  ``czi_golden.json``, and the MPP properties; JpgXr subblocks reach the
  fake as the pixels the test-side JPEG XR encoder recorded for their
  bytes (``regenerate_czi.jxr_pixels``), never through the port;
- the refusals by name (a JpgXr stream cut short and one of a pixel
  format foreign to its pixel type raise when read); a file without a
  directory (walked segment by segment); reads from several threads;
- ``io/pil_resize.py`` against Pillow's ``resize`` bitwise;
- JAX ``main`` against the port's ``main`` with ``WSI_READER=czi`` on a
  small CZI with lossless JpgXr subblocks among its Zstd ones and the
  tiny checkpoint of ``tests/test_torch_pipeline.py``: the same tiles and
  cells, centroids and classes."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import struct
import sys
import threading
import types
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
from golden.jax_native import jax_native_geometry  # noqa: F401

GOLDEN = Path(__file__).parent / "golden"


# ------------------------------------------------------------- the fake

class _Rect:
    def __init__(self, x, y, w, h):
        self.x, self.y, self.w, self.h = x, y, w, h


def _xml_dict(e):
    """xmltodict's form of an element: "@" attributes, children by tag
    (a list where a tag repeats), bare text for a leaf."""
    d = {f"@{k}": v for k, v in e.attrib.items()}
    for c in e:
        v = _xml_dict(c)
        if c.tag in d:
            d[c.tag] = (d[c.tag] if isinstance(d[c.tag], list)
                        else [d[c.tag]]) + [v]
        else:
            d[c.tag] = v
    if not len(e):
        if not d:
            return e.text
        if e.text:
            d["#text"] = e.text
    return d


_TYPES = {0: (1, np.uint8), 3: (3, np.uint8), 4: (3, np.uint16),
          9: (4, np.uint8)}


class FakeCziReader:
    """``pylibCZIrw.czi.CziReader``'s surface that the JAX reader uses:
    ``total_bounding_rectangle``, ``metadata`` and ``read(roi, zoom)``
    (BGR(A) arrays, as pylibCZIrw returns them)."""

    def __init__(self, path):
        b = Path(path).read_bytes()
        if b[:10] != b"ZISRAWFILE":
            raise RuntimeError("not a CZI")
        part, dpos, mpos = struct.unpack_from("<iqq", b, 32 + 48)
        if part:
            raise RuntimeError("a multi-file CZI")
        (n,) = struct.unpack_from("<i", b, dpos + 32)
        pos, self.blocks = dpos + 32 + 128, []
        for k in range(n):
            ptype, fpos, _, comp = struct.unpack_from("<iqii", b, pos + 2)
            (nd,) = struct.unpack_from("<i", b, pos + 28)
            dims = {}
            for i in range(nd):
                o = pos + 32 + 20 * i
                start, size, _, stored = struct.unpack_from("<iifi", b,
                                                            o + 4)
                dims[b[o:o + 4].rstrip(b"\0").decode()] = (start, size,
                                                           stored)
            ms, _, ds = struct.unpack_from("<iiq", b, fpos + 32)
            at = fpos + 32 + max(256, 48 + 20 * nd) + ms
            self.blocks.append(dict(k=k, ptype=ptype, comp=comp, dims=dims,
                                    data=b[at:at + ds]))
            pos += 32 + 20 * nd
        X = [bl["dims"]["X"] for bl in self.blocks]
        Y = [bl["dims"]["Y"] for bl in self.blocks]
        x0, y0 = min(x[0] for x in X), min(y[0] for y in Y)
        self._box = (x0, y0, max(x[0] + x[1] for x in X),
                     max(y[0] + y[1] for y in Y))
        self.total_bounding_rectangle = _Rect(
            x0, y0, self._box[2] - x0, self._box[3] - y0)
        (xs,) = struct.unpack_from("<i", b, mpos + 32)
        root = ET.fromstring(b[mpos + 32 + 256:mpos + 32 + 256 + xs])
        self.metadata = {root.tag: _xml_dict(root)}
        self.closed = False

    @staticmethod
    def _decode(bl) -> np.ndarray:
        import zstandard
        from PIL import Image

        ch, dtype = _TYPES[bl["ptype"]]
        (_, _, sw), (_, _, sh) = bl["dims"]["X"], bl["dims"]["Y"]
        n = sw * sh * ch * np.dtype(dtype).itemsize
        data, comp = bl["data"], bl["comp"]
        if comp == 1:
            rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            return rgb[..., ::-1]
        if comp == 4:
            # the pixels the test-side JPEG XR encoder recorded for these
            # bytes (KeyError for bytes it never wrote)
            from golden.regenerate_czi import jxr_pixels
            rec = jxr_pixels(hashlib.sha256(data).hexdigest())
            if rec.shape != (sh, sw, ch) or rec.dtype != dtype:
                raise NotImplementedError(f"a JpgXr subblock of {rec.shape} "
                                          f"{rec.dtype}")
            return rec
        if comp == 0:
            raw = data[:n]
        elif comp in (5, 6):
            hs = data[0] if comp == 6 else 0
            raw = zstandard.ZstdDecompressor().decompress(
                data[hs:], max_output_size=n)
            if comp == 6 and hs == 3 and data[2] & 1:
                lo, hi = raw[:n // 2], raw[n // 2:]
                raw = bytes(b for pair in zip(lo, hi) for b in pair)
        else:
            raise NotImplementedError(f"compression {comp}")
        return np.frombuffer(raw, np.dtype(dtype).newbyteorder("<")) \
            .reshape(sh, sw, ch)

    def read(self, roi, zoom):
        from PIL import Image

        x, y, w, h = roi
        bx0, by0, bx1, by1 = self._box
        xs, ys, xe, ye = max(x, bx0), max(y, by0), min(x + w, bx1), \
            min(y + h, by1)
        plane = [bl for bl in self.blocks
                 if all(bl["dims"].get(d, (0,))[0] == 0 for d in "CZT")]

        def factor(bl):
            _, size, stored = bl["dims"]["X"]
            return max(1, round(size / stored))

        f = max(g for g in {factor(bl) for bl in plane}
                if 1 / g >= zoom - 1e-12)
        layer = sorted([bl for bl in plane if factor(bl) == f],
                       key=lambda bl: (bl["dims"].get("M", (-1,))[0],
                                       bl["k"]))
        ch, dtype = _TYPES[plane[0]["ptype"]]
        canvas = np.zeros((ye - ys, xe - xs, ch), dtype)
        for bl in layer:
            (X0, XS, XST), (Y0, YS, YST) = bl["dims"]["X"], bl["dims"]["Y"]
            px = self._decode(bl)
            doc = px[np.arange(YS) * YST // YS][:, np.arange(XS) * XST // XS]
            ox0, oy0 = max(X0, xs), max(Y0, ys)
            ox1, oy1 = min(X0 + XS, xe), min(Y0 + YS, ye)
            if ox1 > ox0 and oy1 > oy0:
                canvas[oy0 - ys:oy1 - ys, ox0 - xs:ox1 - xs] = \
                    doc[oy0 - Y0:oy1 - Y0, ox0 - X0:ox1 - X0]
        cw, chh = xe - xs, ye - ys
        ow = max(1, int(round(cw * zoom)))
        oh = max(1, int(round(chh * zoom)))
        if (oh, ow) != canvas.shape[:2]:
            def idx(n, m):          # PIL NEAREST's source of each pixel
                im = Image.fromarray(np.arange(n, dtype=np.int32)[None, :])
                return np.asarray(im.resize((m, 1), Image.NEAREST))[0]
            canvas = canvas[idx(chh, oh)][:, idx(cw, ow)]
        return canvas

    def close(self):
        self.closed = True


@contextlib.contextmanager
def fake_pylibczirw():
    """``pylibCZIrw.czi`` with :class:`FakeCziReader`, in ``sys.modules``
    for the block."""
    pkg = types.ModuleType("pylibCZIrw")
    mod = types.ModuleType("pylibCZIrw.czi")
    mod.CziReader = FakeCziReader
    pkg.czi = mod
    saved = {k: sys.modules.get(k) for k in ("pylibCZIrw", "pylibCZIrw.czi")}
    sys.modules.update({"pylibCZIrw": pkg, "pylibCZIrw.czi": mod})
    try:
        yield mod
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@contextlib.contextmanager
def jax_czi_slide(path):
    """The JAX package's ``CZISlide`` over the fake."""
    from classpose_tpu.io.czi_reader import CZISlide

    with fake_pylibczirw():
        s = CZISlide(str(path))
    try:
        yield s
    finally:
        s.close()


# ----------------------------------------------------------- the goldens

def _golden():
    return json.loads((GOLDEN / "czi_golden.json").read_text())


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", ["czi_mosaic", "czi_pyramid", "czi_scenes",
                                  "czi_bgr48", "czi_bgra32", "czi_jpeg",
                                  "czi_region", "czi_jpgxr",
                                  "czi_jpgxr_bgr48", "czi_jpgxr_bgra32",
                                  "czi_jpgxr_pyramid"])
def test_golden_against_jax(name):
    """Every golden read, bitwise against the JAX reader over the fake and
    against the committed hash; dimensions, levels and MPP alike."""
    from classpose_tpu_torch.io import CZISlide

    g = _golden()["files"][name]
    path = GOLDEN / f"{name}.czi"
    port = CZISlide(str(path))
    with jax_czi_slide(path) as ref:
        assert port.level_count == ref.level_count == 5
        assert port.level_downsamples == ref.level_downsamples
        assert port.level_dimensions == ref.level_dimensions
        assert list(port.dimensions) == g["dimensions"]
        assert port.properties == ref.properties
        assert port.properties.get("openslide.mpp-x") == g["mpp"]
        for x, y, lv, w, h, sha in g["reads"]:
            got = port.read_region((x, y), lv, (w, h))
            want = np.asarray(ref.read_region((x, y), lv, (w, h)))
            assert got.shape == want.shape == (h, w, 4), (x, y, lv)
            assert np.array_equal(got, want), (name, x, y, lv, w, h)
            assert _sha(got) == sha, (name, x, y, lv)
        for ds in (0.5, 1.0, 3.0, 5.0, 16.0, 40.0):
            assert port.get_best_level_for_downsample(ds) == \
                ref.get_best_level_for_downsample(ds)
    thumb = port.get_thumbnail((16, 16))
    assert thumb.ndim == 3 and thumb.shape[2] == 3 and \
        max(thumb.shape[:2]) <= 16
    port.close()


def test_pyramid_layers_are_read():
    """A zoom below 1 reads the box-filtered pyramid layer, which differs
    from layer 0 subsampled: a reader that ignored pyramids would fail."""
    from classpose_tpu_torch.io import CZISlide

    s = CZISlide(str(GOLDEN / "czi_pyramid.czi"))
    w, h = s.level_dimensions[1]
    lv1 = s.read_region((0, 0), 1, (w, h))
    lv0 = s.read_region((0, 0), 0, (2 * w, 2 * h))
    assert not np.array_equal(lv1, lv0[::2, ::2])
    s.close()


@pytest.mark.parametrize("name", ["czi_refused_jpgxr",
                                  "czi_refused_jpgxr_pixel_format",
                                  "czi_refused_lzw", "czi_refused_camera",
                                  "czi_refused_gray8",
                                  "czi_refused_filepart"])
def test_refusals(name):
    """LZW, camera-specific compressions, grey slides and multi-file CZIs
    raise a ValueError that names each when opened; a JpgXr stream cut
    short, and one whose pixel format does not belong with its pixel
    type, when read. The fake cannot read them either."""
    from classpose_tpu_torch.io import CZISlide

    match = _golden()["refused"][name]
    path = str(GOLDEN / f"{name}.czi")
    if name.startswith("czi_refused_jpgxr"):
        slide = CZISlide(path)
        with pytest.raises(ValueError, match=match):
            slide.read_region((0, 0), 0, (16, 16))
        slide.close()
    else:
        with pytest.raises(ValueError, match=match):
            CZISlide(path)
    if name != "czi_refused_filepart":
        with pytest.raises((NotImplementedError, TypeError, KeyError)):
            with jax_czi_slide(GOLDEN / f"{name}.czi") as ref:
                ref.read_region((0, 0), 0, (16, 16))


def test_file_without_directory_is_walked(tmp_path):
    """With DirectoryPosition 0 the subblocks are found segment by segment,
    past the DELETED segment and the attachments, to the same pixels."""
    from classpose_tpu_torch.io import CZISlide

    raw = bytearray((GOLDEN / "czi_mosaic.czi").read_bytes())
    struct.pack_into("<q", raw, 32 + 52, 0)
    path = tmp_path / "nodir.czi"
    path.write_bytes(bytes(raw))
    a, b = CZISlide(str(GOLDEN / "czi_mosaic.czi")), CZISlide(str(path))
    for lv in range(5):
        w, h = a.level_dimensions[lv]
        assert np.array_equal(a.read_region((0, 0), lv, (w, h)),
                              b.read_region((0, 0), lv, (w, h)))
    a.close()
    b.close()


def test_corrupt_files_raise_value_error(tmp_path):
    """Cuts and random byte edits of a golden open and read or raise a
    ValueError, never another error (small reads: an edited size may
    name a slide too large to read whole)."""
    from classpose_tpu_torch.io import CZISlide

    raw = (GOLDEN / "czi_mosaic.czi").read_bytes()
    rng = np.random.default_rng(0)
    path = tmp_path / "bad.czi"
    for k in range(240):
        b = bytearray(raw)
        if k % 3 == 0:
            b = b[:rng.integers(0, len(b))]
        else:
            for _ in range(rng.integers(1, 6)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
        path.write_bytes(bytes(b))
        try:
            s = CZISlide(str(path))
            for lv in (0, 2):
                s.read_region((3, 5), lv, (40, 24))
            s.close()
        except ValueError:
            pass


def test_reads_from_threads(monkeypatch):
    """Reader threads share the file (``os.pread``) and the subblock
    cache, here small enough to evict: the same pixels as one thread."""
    from classpose_tpu_torch.io import CZISlide, czi_reader

    monkeypatch.setattr(czi_reader, "CACHE_BYTES", 3 << 20)
    s = CZISlide(str(GOLDEN / "czi_region.czi"))
    spots = [((x, y), 0, (300, 260)) for x in (0, 700, 1500)
             for y in (0, 900, 1700)]
    want = [s.read_region(*a) for a in spots]
    got = [None] * (4 * len(spots))

    def work(i):
        got[i] = s.read_region(*spots[i % len(spots)])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(got))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, g in enumerate(got):
        assert np.array_equal(g, want[i % len(spots)])
    s.close()


# ------------------------------------------------------------ pil_resize

@pytest.mark.parametrize("src,dst", [
    ((31, 17), (64, 64)), ((64, 64), (31, 17)), ((1, 1), (5, 3)),
    ((497, 512), (512, 512)), ((512, 300), (512, 512)), ((7, 90), (40, 11)),
    ((128, 128), (128, 100))])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pil_resize_bitwise(src, dst, mode):
    """Pillow 12.1.0's default ``resize`` (BICUBIC, premultiplied RGBA at
    alpha 255) and PIL's NEAREST source positions, bit for bit."""
    from PIL import Image

    from classpose_tpu_torch.io import pil_resize
    from classpose_tpu_torch.io.czi_reader import nearest_index

    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = rng.integers(0, 256, (src[1], src[0], len(mode)), np.uint8)
    if mode == "RGBA":
        img[..., 3] = 255
    want = np.asarray(Image.fromarray(img, mode).resize(dst))
    assert np.array_equal(pil_resize.resize(img, dst), want)
    im = Image.fromarray(np.arange(src[0], dtype=np.int32)[None, :])
    assert np.array_equal(nearest_index(src[0], dst[0]), np.asarray(
        im.resize((dst[0], 1), Image.NEAREST))[0])


# ------------------------------------------------- the CLI, JAX against port

def _czi_runs(tmp):
    from classpose_tpu.io.array_reader import synthetic_wsi
    from classpose_tpu.nn import ClassTransformerConfig as JaxCfg
    from classpose_tpu.nn.convert import save_params
    from classpose_tpu.nn.synthetic import perturbed_structured_params
    from classpose_tpu.pipeline.predict_wsi import main as jax_main
    from classpose_tpu_torch.pipeline.predict_wsi import main as port_main
    from golden.regenerate_czi import scaling_xml, region_tiles, write_czi
    from test_torch_pipeline import CFG, LABELS, _args

    slide, _ = synthetic_wsi(width=700, height=600, n_cells=60, seed=4,
                             mpp=0.4)
    # lossless JpgXr in both orders, at overlap 1 and 2, on an edge tile
    tiles = region_tiles(slide._level0, tile=256, level=1, jpgxr={
        2: dict(overlap=2), 4: dict(overlap=1, frequency=True),
        7: dict(overlap=2, tile_w=(4,), hard=True)})
    assert [t.compression for t in tiles[:9]].count(4) == 3
    write_czi(tmp / "slide.czi", tiles, scaling_xml(0.4))
    cfg = JaxCfg(**CFG)
    save_params(perturbed_structured_params(cfg, ripple=0.5, seed=0),
                str(tmp / "ckpt.npz"), cfg=cfg)
    (tmp / "config.yaml").write_text(
        f"path: {tmp}/ckpt.npz\nmpp: 0.5\ncell_types:\n"
        + "".join(f"- {c}\n" for c in LABELS))

    def args(out, device):
        a = _args(tmp, out, device)
        a.slide_path, a.mpp = str(tmp / "slide.czi"), None
        return a

    old = os.environ.get("WSI_READER")
    os.environ["WSI_READER"] = "czi"
    try:
        with fake_pylibczirw():
            ref = jax_main(args(tmp / "jax", None))
        got = port_main(args(tmp / "port", "cpu"))
    finally:
        if old is None:
            os.environ.pop("WSI_READER", None)
        else:
            os.environ["WSI_READER"] = old
    return tmp, ref, got


@pytest.fixture(scope="module")
def czi_runs(tmp_path_factory):
    return _czi_runs(tmp_path_factory.mktemp("wsi_czi"))


def test_czi_slide_same_tiles_and_cells(czi_runs):
    _, ref, got = czi_runs
    assert got["n_tiles"] == ref["n_tiles"] == 4
    assert ref["n_cells"] >= 20
    assert abs(got["n_cells"] - ref["n_cells"]) <= 0.005 * ref["n_cells"]


def test_czi_slide_centroids_and_classes_match(czi_runs):
    from scipy.spatial import cKDTree

    from test_torch_pipeline import _centroids

    tmp, _, _ = czi_runs
    ref_pts, ref_names = _centroids(tmp / "jax" /
                                    "slide_cell_centroids.geojson")
    pts, names = _centroids(tmp / "port" / "slide_cell_centroids.geojson")
    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    same = [np.isfinite(d) and names[i] == ref_names[j]
            for i, (d, j) in enumerate(zip(dist, idx))]
    assert np.mean(same) >= 0.99
