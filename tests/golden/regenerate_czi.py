"""Regenerate the CZI goldens: small Zeiss ``.czi`` files written here with
``struct``, ``zstandard`` and PIL, the hashes of what the JAX package's
``CZISlide`` reads from them, and the slide region the card's CLI run
reads (``tests/test_torch_czi.py`` and ``chip_smoke.py``, which has
neither zstandard nor PIL nor JAX).

- ``czi_mosaic.czi``: Bgr24 tiles that overlap, with M indices out of file
  order, at a negative document origin; uncompressed, Zstd0 and Zstd1
  (header of 1 and of 3 bytes) subblocks; a ``DELETED`` segment, an
  attachment and an attachment directory; MPP 0.25 µm.
- ``czi_pyramid.czi``: Bgr24 Zstd0 tiles and two MultiSubblock pyramid
  layers (zoom 1/2 and 1/4), each box-filtered from the one below, so a
  reader that ignores pyramids reads other pixels.
- ``czi_scenes.czi``: two scenes apart (the gap is background), Zstd1, a
  second channel (C = 1) that is never read, and metadata without
  Scaling.
- ``czi_bgr48.czi``: Bgr48 under Zstd1 with hi/lo byte packing.
- ``czi_bgra32.czi``: Bgra32, uncompressed and Zstd0.
- ``czi_jpeg.czi``: JpgFile tiles (PIL, quality 90).
- ``czi_jpgxr.czi``, ``czi_jpgxr_bgr48.czi``, ``czi_jpgxr_bgra32.czi``
  and ``czi_jpgxr_pyramid.czi``: JpgXrFile subblocks written by the
  test-side JPEG XR encoder (``tests/golden/regenerate_jxr.py``):
  lossless and lossy, spatial and frequency order, overlap 0-2, tiles,
  4:2:0; Bgr48 (48bppRGB); Bgra32 with an interleaved and a planar alpha;
  a Zstd0 layer 0 under JpgXr pyramid layers.
- ``czi_refused_*.czi``: a JpgXrFile subblock cut short, one of a pixel
  format that does not belong with its pixel type, LZW and
  camera-specific subblocks, a Gray8 slide and FilePart 1, each of which
  the port refuses by name.
- ``czi_region.czi``: the ``[0:2048, 0:2048]`` region of
  ``synthetic_wsi(6144, 6144, n_cells=4000, mpp=0.4, seed=0)`` (the WSI
  phase's slide of ``chip_smoke.py``) in 16 tiles of 512² (8 lossless
  JpgXr in spatial and frequency order, at overlap 0, 1 and 2, with soft
  and hard tiles; Zstd1, Zstd0 and one uncompressed at zstd level 19)
  with one pyramid layer at zoom 1/2, MPP 0.4 in its metadata, at a
  document origin of (9000, -3000).
- ``czi_golden.json``: for every file but the refused ones, the SHA-256 of
  the JAX ``CZISlide``'s ``read_region`` (over the test's pylibCZIrw fake,
  ``tests/test_torch_czi.py``) at each level, on edge requests and inside,
  with its MPP property; the refusals' expected messages; for each JpgXr
  subblock (by the SHA-256 of its bytes) the golden and tile it comes
  from, whence the fake takes the encoder's recorded pixels.

Run: python tests/golden/regenerate_czi.py
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

try:                                  # imported as golden.regenerate_czi
    from . import regenerate_jxr as jxr
except ImportError:                   # run as a script
    import regenerate_jxr as jxr

HERE = Path(__file__).parent
JSON_NAME = "czi_golden.json"
REGION_NAME = "czi_region.czi"
REGION, REGION_TILE, REGION_MPP = 2048, 512, 0.4
REGION_ORIGIN = (9000, -3000)
SLIDE = dict(width=6144, height=6144, n_cells=4000, mpp=REGION_MPP, seed=0)

UNCOMPRESSED, JPG, LZW, JPGXR, ZSTD0, ZSTD1 = 0, 1, 2, 4, 5, 6
GRAY8, BGR24, BGR48, BGRA32 = 0, 3, 4, 9


@dataclass
class Tile:
    """One subblock: its document rectangle's origin and logical size,
    its stored BGR(A) pixels, and how it is written."""
    x: int
    y: int
    pixels: np.ndarray
    ptype: int = BGR24
    compression: int = ZSTD0
    logical: tuple[int, int] | None = None   # (w, h); None: stored size
    m: int | None = None
    s: int | None = None
    c: int = 0
    pyramid: int = 0
    zstd1_header: int = 3                    # 1 or 3
    hilo: bool = False
    level: int = 3
    jxr: object = None                       # JpgXr: the encoder's Params
    cut: bool = False                        # JpgXr: its last quarter cut
    encoded: bytes = b""                     # the subblock's data, once


def _segment(sid: str, data: bytes) -> bytes:
    alloc = (len(data) + 31) // 32 * 32
    return (sid.encode().ljust(16, b"\0") + struct.pack("<qq", alloc,
                                                        len(data))
            + data.ljust(alloc, b"\0"))


def _dv(t: Tile, position: int) -> bytes:
    h, w = t.pixels.shape[:2]
    lw, lh = t.logical or (w, h)
    dims = [("X", t.x, lw, w), ("Y", t.y, lh, h), ("C", t.c, 1, 1)]
    if t.s is not None:
        dims.append(("S", t.s, 1, 1))
    if t.m is not None:
        dims.append(("M", t.m, 1, 1))
    b = b"DV" + struct.pack("<iqiiB5xi", t.ptype, position, 0,
                            t.compression, t.pyramid, len(dims))
    for name, start, size, stored in dims:
        b += name.encode().ljust(4, b"\0") + struct.pack(
            "<iifi", start, size, float(start), stored)
    return b


# the SHA-256 of a JpgXr subblock's bytes -> the pixels its encoder
# recorded (filled as subblocks are encoded; ``jxr_pixels`` rebuilds the
# committed goldens' entries)
JXR_RECORD: dict[str, np.ndarray] = {}
JXR_FORMAT = {BGR24: "24bppBGR", BGR48: "48bppRGB", BGRA32: "32bppBGRA"}


def jxr_params(ptype: int = BGR24, **kw) -> jxr.Params:
    """JPEG XR settings for a subblock of ``ptype``: lossless unless a
    plane is given; Bgra32 with an interleaved alpha plane unless
    ``planar_alpha``."""
    if ptype == BGRA32 and "planar_alpha" not in kw and "alpha" not in kw:
        kw["alpha"] = jxr.Plane(fmt="Y")
    return jxr.Params(pixel_format=JXR_FORMAT[ptype], **kw)


def _zstd(raw: bytes, level: int) -> bytes:
    import zstandard
    return zstandard.ZstdCompressor(level=level).compress(raw)


def encode(t: Tile) -> bytes:
    """The subblock's data in its compression; a refused compression gets
    placeholder bytes."""
    px = np.ascontiguousarray(t.pixels)
    raw = px.astype(px.dtype.newbyteorder("<")).tobytes()
    if t.compression == UNCOMPRESSED:
        return raw
    if t.compression == ZSTD0:
        return _zstd(raw, t.level)
    if t.compression == ZSTD1:
        if t.hilo:
            b = np.frombuffer(raw, np.uint8)
            raw = b[0::2].tobytes() + b[1::2].tobytes()
        head = bytes([1]) if t.zstd1_header == 1 else \
            bytes([3, 1, int(t.hilo)])
        return head + _zstd(raw, t.level)
    if t.compression == JPG:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(px[..., ::-1]).save(buf, "JPEG", quality=90)
        return buf.getvalue()
    if t.compression == JPGXR and t.jxr is not None:
        data, rec = jxr.encode(px, t.jxr)
        if t.cut:
            return data[:len(data) * 3 // 4]
        JXR_RECORD[sha256_bytes(data)] = rec
        return data
    return b"\x00not decodable here\x00" * 8


def scaling_xml(mpp: float | None, extra: str = "") -> str:
    """ImageDocument metadata; with ``mpp``, Scaling/Items/Distance X and
    Y in metres, written as the shortest repr whose ``float() * 1e6`` is
    ``mpp`` again (ZEN writes such round-trip strings)."""
    body = extra
    if mpp is not None:
        v = mpp * 1e-6
        while v * 1e6 != mpp:
            v = float(np.nextafter(v, np.inf if v * 1e6 < mpp else 0))
        text = repr(v).upper()
        body += ("<Scaling><Items>" + "".join(
            f'<Distance Id="{a}"><Value>{text}</Value>'
            f'<DefaultUnitFormat>µm</DefaultUnitFormat></Distance>'
            for a in "XY") + "</Items></Scaling>")
    return (f"<ImageDocument><Metadata><Information><Image>"
            f"<SizeC>1</SizeC></Image></Information>{body}</Metadata>"
            f"</ImageDocument>")


def write_czi(path, tiles: list[Tile], xml: str, *, file_part: int = 0,
              extras: bool = False) -> None:
    """A ZISRAW file: the header, the subblocks in list order, optionally
    a ``DELETED`` segment, an attachment and its directory, the
    metadata, and the directory."""
    out = bytearray(_segment("ZISRAWFILE", bytes(480)))
    entries = []
    for t in tiles:
        pos = len(out)
        data = t.encoded = encode(t)
        entry = _dv(t, pos)
        meta = b"<METADATA><Tags><AcquisitionTime/></Tags></METADATA>"
        head = struct.pack("<iiq", len(meta), 0, len(data)) + entry
        head = head.ljust(max(256, len(head)), b"\0")
        out += _segment("ZISRAWSUBBLOCK", head + meta + data)
        entries.append(entry)
    att_dir = 0
    if extras:
        out += _segment("DELETED", b"\xab" * 200)
        att_pos = len(out)
        a1 = (b"A1" + bytes(10) + struct.pack("<qi", att_pos, 0) + bytes(16)
              + b"JPG".ljust(8, b"\0") + b"Thumbnail".ljust(80, b"\0"))
        payload = b"\xff\xd8 not a thumbnail \xff\xd9"
        out += _segment("ZISRAWATTACH", struct.pack("<i", len(payload))
                        + bytes(12) + a1 + bytes(112) + payload)
        att_dir = len(out)
        out += _segment("ZISRAWATTDIR", struct.pack("<i", 1) + bytes(252)
                        + a1)
    meta_pos = len(out)
    xb = xml.encode()
    out += _segment("ZISRAWMETADATA",
                    struct.pack("<ii", len(xb), 0).ljust(256, b"\0") + xb)
    dir_pos = len(out)
    out += _segment("ZISRAWDIRECTORY", struct.pack("<i", len(entries))
                    .ljust(128, b"\0") + b"".join(entries))
    struct.pack_into("<ii", out, 32, 1, 0)
    struct.pack_into("<iqq", out, 32 + 48, file_part, dir_pos, meta_pos)
    struct.pack_into("<q", out, 32 + 72, att_dir)
    Path(path).write_bytes(bytes(out))


def box2(img: np.ndarray) -> np.ndarray:
    """2 × 2 box filter (rounded mean) of an (H, W, C) image."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    s = img[:h, :w].astype(np.uint32)
    s = s[0::2, 0::2] + s[1::2, 0::2] + s[0::2, 1::2] + s[1::2, 1::2]
    return ((s + 2) // 4).astype(img.dtype)


def grid(img: np.ndarray, x0: int, y0: int, tw: int, th: int, **kw
         ) -> list[Tile]:
    """``img`` cut into tiles of (th, tw) at document origin (x0, y0)."""
    out = []
    for y in range(0, img.shape[0], th):
        for x in range(0, img.shape[1], tw):
            out.append(Tile(x0 + x, y0 + y, img[y:y + th, x:x + tw], **kw))
    return out


def pyramid_layer(img: np.ndarray, factor: int, x0: int, y0: int, tw: int,
                  th: int, **kw) -> list[Tile]:
    """Tiles of ``img`` box-filtered ``factor`` times over (a power of
    2), each covering ``factor`` times its stored size."""
    small = img
    f = 1
    while f < factor:
        small, f = box2(small), f * 2
    tiles = grid(small, 0, 0, tw, th, pyramid=2, **kw)
    for t in tiles:
        t.logical = (t.pixels.shape[1] * factor, t.pixels.shape[0] * factor)
        t.x, t.y = x0 + t.x * factor, y0 + t.y * factor
    return tiles


def _noise(rng, h, w, ch=3, dtype=np.uint8):
    hi = 65536 if dtype == np.uint16 else 256
    return rng.integers(0, hi, (h, w, ch)).astype(dtype)


def _smooth(rng, h, w):
    """Texture a JPEG keeps well: blurred noise."""
    from scipy.ndimage import uniform_filter
    img = uniform_filter(rng.integers(0, 256, (h, w, 3)).astype(float),
                         (7, 7, 1))
    return np.clip((img - 128) * 3 + 128, 0, 255).astype(np.uint8)


def goldens() -> dict[str, tuple[list[Tile], str, dict]]:
    """name -> (tiles, metadata XML, write_czi options) of every small
    golden."""
    rng = np.random.default_rng(17)
    files = {}
    # overlapping tiles, M out of file order, negative origin
    tiles = []
    comps = [(UNCOMPRESSED, 3), (ZSTD0, 3), (ZSTD1, 1), (ZSTD1, 3),
             (ZSTD0, 3), (ZSTD1, 3)]
    ms = [4, 0, 5, 2, 1, 3]
    for i in range(6):
        gx, gy = i % 3, i // 3
        c, hs = comps[i]
        tiles.append(Tile(-130 + gx * 56, -45 + gy * 40, _noise(rng, 48, 64),
                          compression=c, zstd1_header=hs, m=ms[i], s=0))
    files["czi_mosaic"] = (tiles, scaling_xml(0.25), dict(extras=True))
    # layer 0 and two box-filtered pyramid layers
    base = _noise(rng, 96, 128)
    tiles = grid(base, 10, 20, 64, 48, m=None)
    for i, t in enumerate(tiles):
        t.m = i
    tiles += pyramid_layer(base, 2, 10, 20, 64, 48)
    tiles += pyramid_layer(base, 4, 10, 20, 64, 48)
    files["czi_pyramid"] = (tiles, scaling_xml(0.5), {})
    # two scenes apart, a channel 1 that is never read, no Scaling
    tiles = [Tile(0, 0, _noise(rng, 50, 60), compression=ZSTD1, s=0, m=0),
             Tile(200, 120, _noise(rng, 40, 70), compression=ZSTD1, s=1,
                  m=0),
             Tile(0, 0, _noise(rng, 50, 60), compression=ZSTD1, s=0, m=0,
                  c=1)]
    files["czi_scenes"] = (tiles, scaling_xml(
        None, "<DisplaySetting><Channels/></DisplaySetting>"), {})
    # 16-bit samples with hi/lo packing
    tiles = grid(_noise(rng, 40, 90, dtype=np.uint16), 3, 4, 45, 40,
                 ptype=BGR48, compression=ZSTD1, hilo=True)
    files["czi_bgr48"] = (tiles, scaling_xml(0.2), {})
    tiles = grid(_noise(rng, 30, 80, ch=4), 0, 0, 40, 30, ptype=BGRA32)
    tiles[0].compression = UNCOMPRESSED
    files["czi_bgra32"] = (tiles, scaling_xml(0.3), {})
    tiles = grid(_smooth(rng, 64, 128), 7, 0, 64, 64, compression=JPG)
    files["czi_jpeg"] = (tiles, scaling_xml(0.45), {})
    files.update(jpgxr_goldens(rng))
    return files


def jpgxr_goldens(rng) -> dict[str, tuple[list[Tile], str, dict]]:
    """The JpgXr goldens: every subblock's settings differ."""
    lossy420 = jxr.Plane(fmt="420", scaled=True, dc=("image", (0, (4,))),
                         lp=("image", (1, (8, 20))),
                         hp=("image", (2, (10, 30, 40))))
    files = {}
    tiles = grid(_smooth(rng, 64, 96), 5, -6, 32, 32, compression=JPGXR)
    for t, kw in zip(tiles, [
            dict(), dict(overlap=2, frequency=True, tile_w=(1,)),
            dict(plane=lossy420, overlap=2), dict(overlap=0), None,
            dict(trim=2, plane=jxr.Plane(scaled=True,
                                         hp=("image", (0, (6,)))))]):
        if kw is None:
            t.compression = ZSTD1
        else:
            t.jxr = jxr_params(**kw)
    files["czi_jpgxr"] = (tiles, scaling_xml(0.35), {})
    px = np.stack([_smooth(rng, 40, 90)[..., i].astype(np.uint16) * 257 + i
                   for i in range(3)], -1)
    tiles = grid(px, 3, 4, 45, 40, ptype=BGR48, compression=JPGXR)
    tiles[0].jxr = jxr_params(BGR48, overlap=2)
    tiles[1].jxr = jxr_params(BGR48, frequency=True, shift_bits=2,
                              plane=jxr.Plane(dc=("image", (0, (5,)))))
    files["czi_jpgxr_bgr48"] = (tiles, scaling_xml(0.2), {})
    px = np.concatenate([_smooth(rng, 30, 80), _smooth(rng, 30, 80)[..., :1]],
                        -1)
    tiles = grid(px, 0, 0, 40, 30, ptype=BGRA32, compression=JPGXR)
    tiles[0].jxr = jxr_params(BGRA32)
    tiles[1].jxr = jxr_params(BGRA32, planar_alpha=jxr.Plane(fmt="Y"),
                              overlap=2)
    files["czi_jpgxr_bgra32"] = (tiles, scaling_xml(0.3), {})
    base = _smooth(rng, 96, 128)
    tiles = grid(base, 10, 20, 64, 48)
    for i, t in enumerate(tiles):
        t.m = i
    for factor, kw in ((2, dict(overlap=2)), (4, dict(frequency=True))):
        for t in pyramid_layer(base, factor, 10, 20, 64, 48,
                               compression=JPGXR):
            t.jxr = jxr_params(**kw)
            tiles.append(t)
    files["czi_jpgxr_pyramid"] = (tiles, scaling_xml(0.5), {})
    return files


# name -> (tiles, options, what the refusal names)
def refused() -> dict[str, tuple[list[Tile], dict, str]]:
    rng = np.random.default_rng(3)
    px = _noise(rng, 16, 16)
    cut = Tile(0, 0, px, compression=JPGXR, jxr=jxr_params(), cut=True)
    wide = Tile(0, 0, px, compression=JPGXR, jxr=jxr_params(BGR48))
    return {
        "czi_refused_jpgxr": ([cut], {}, "JPEG XR"),
        "czi_refused_jpgxr_pixel_format": (
            [wide], {}, "JpgXrFile subblock of 48bppRGB for Bgr24"),
        "czi_refused_lzw": ([Tile(0, 0, px, compression=LZW)], {}, "LZW"),
        "czi_refused_camera": ([Tile(0, 0, px, compression=1001)], {},
                               "camera-specific compression 1001"),
        "czi_refused_gray8": ([Tile(0, 0, px[..., :1], ptype=GRAY8,
                                    compression=UNCOMPRESSED)], {}, "Gray8"),
        "czi_refused_filepart": ([Tile(0, 0, px)], dict(file_part=1),
                                 "multi-file"),
    }


# the region's lossless JpgXr tiles (by index in the 4 × 4 grid): spatial
# and frequency order, overlap 0, 1 and 2, one tile, soft and hard tiles
REGION_JXR = {
    1: dict(overlap=0),
    2: dict(overlap=1),
    4: dict(overlap=2),
    7: dict(overlap=1, frequency=True),
    8: dict(overlap=2, frequency=True, tile_w=(16,), tile_h=(16,)),
    11: dict(overlap=2, tile_w=(10,), tile_h=(20,), hard=True),
    13: dict(overlap=2, frequency=True, tile_w=(8, 8, 8),
             tile_h=(8, 8, 8), hard=True),
    14: dict(overlap=1, tile_w=(5, 20), tile_h=(12,)),
}


def region_tiles(region: np.ndarray, tile: int = REGION_TILE,
                 level: int = 19, jpgxr: dict | None = None) -> list[Tile]:
    """The region in tiles of ``tile``² (RGB → BGR): lossless JpgXr where
    ``jpgxr`` (index -> encoder settings; ``REGION_JXR`` by default) says,
    the sixth uncompressed, Zstd1 and Zstd0 in turn otherwise, with a
    zoom-1/2 pyramid layer, at zstd ``level``."""
    bgr = np.ascontiguousarray(region[..., ::-1])
    x0, y0 = REGION_ORIGIN
    tiles = grid(bgr, x0, y0, tile, tile, level=level)
    for i, t in enumerate(tiles):
        t.m = i
        t.compression = (ZSTD1, ZSTD0)[i % 2]
        t.zstd1_header = (1, 3)[(i // 2) % 2]
    tiles[5].compression = UNCOMPRESSED
    for i, kw in (REGION_JXR if jpgxr is None else jpgxr).items():
        if i < len(tiles):
            tiles[i].compression = JPGXR
            tiles[i].jxr = jxr_params(**kw)
    tiles += pyramid_layer(bgr, 2, x0, y0, tile, tile, level=level)
    return tiles


def reads(dims: tuple[int, int]) -> list[tuple[int, int, int, int, int]]:
    """(x, y, level, w, h) of the golden reads of a slide of level-0
    ``dims``: every level whole, edge requests that reach past the right
    and bottom, and a request inside."""
    W, H = dims
    out = [(0, 0, lv, max(1, W >> lv), max(1, H >> lv)) for lv in range(5)]
    out += [(W - 20, H - 10, 0, 48, 40), (W - 40, 0, 1, 32, 32),
            (0, H - 12, 2, 24, 16), (5, 7, 0, 33, 21), (9, 3, 1, 17, 30)]
    return out


REGION_READS = [(1000, 700, 0, 512, 512), (0, 0, 1, 1024, 1024),
                (0, 0, 2, 512, 512), (0, 0, 3, 256, 256), (0, 0, 4, 128, 128),
                (2000, 1990, 0, 100, 100), (1536, 1024, 1, 300, 300)]


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def sha256_bytes(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def region_source() -> np.ndarray:
    """The slide region of ``czi_region.czi`` (RGB)."""
    sys.path.insert(0, str(HERE.parents[1]))
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    slide, _ = synthetic_wsi(**SLIDE)
    return slide._level0[:REGION, :REGION]


_TILES: dict[str, list[Tile]] = {}


def jxr_pixels(digest: str) -> np.ndarray:
    """The pixels the encoder recorded for the JpgXr subblock whose bytes
    have SHA-256 ``digest``: from this process's encodings, else from the
    golden and tile that ``czi_golden.json`` names (rebuilt from their
    seeds; lossy ones encoded again); KeyError for any other."""
    if digest in JXR_RECORD:
        return JXR_RECORD[digest]
    name, index = json.loads((HERE / JSON_NAME).read_text())["jpgxr"][digest]
    if name not in _TILES:
        _TILES[name] = region_tiles(region_source()) \
            if name == Path(REGION_NAME).stem else goldens()[name][0]
    t = _TILES[name][index]
    if jxr.lossless(t.jxr):       # the encoder checked it kept the source
        rec = np.ascontiguousarray(t.pixels)
    else:
        data, rec = jxr.encode(np.ascontiguousarray(t.pixels), t.jxr)
        if sha256_bytes(data) != digest:
            raise AssertionError(f"{name} tile {index} encodes otherwise "
                                 f"now")
    JXR_RECORD[digest] = rec
    return rec


def main():
    sys.path.insert(0, str(HERE.parent))
    sys.path.insert(0, str(HERE.parents[1]))
    # the fake reads JpgXr subblocks through this module's record
    sys.modules.setdefault("golden.regenerate_czi", sys.modules[__name__])
    from classpose_tpu_torch.io.array_reader import synthetic_wsi
    from test_torch_czi import jax_czi_slide

    golden = {"files": {}, "refused": {}, "jpgxr": {}}

    def record(name, tiles):
        for i, t in enumerate(tiles):
            if t.compression == JPGXR:
                golden["jpgxr"][sha256_bytes(t.encoded)] = [name, i]

    for name, (tiles, xml, kw) in goldens().items():
        write_czi(HERE / f"{name}.czi", tiles, xml, **kw)
        record(name, tiles)
    for name, (tiles, kw, match) in refused().items():
        write_czi(HERE / f"{name}.czi", tiles, scaling_xml(0.5), **kw)
        golden["refused"][name] = match
    slide, _ = synthetic_wsi(**SLIDE)
    region = slide._level0[:REGION, :REGION]
    tiles = region_tiles(region)
    write_czi(HERE / REGION_NAME, tiles, scaling_xml(REGION_MPP))
    record(Path(REGION_NAME).stem, tiles)
    for name in list(goldens()) + [Path(REGION_NAME).stem]:
        with jax_czi_slide(HERE / f"{name}.czi") as s:
            rs = REGION_READS if name == Path(REGION_NAME).stem else \
                reads(s.dimensions)
            golden["files"][name] = {
                "dimensions": list(s.dimensions),
                "mpp": s.properties.get("openslide.mpp-x"),
                "reads": [[x, y, lv, w, h, sha256(np.asarray(
                    s.read_region((x, y), lv, (w, h))))]
                    for x, y, lv, w, h in rs]}
    golden["region"] = {"slide": SLIDE, "region": REGION,
                        "tile": REGION_TILE, "origin": list(REGION_ORIGIN)}
    (HERE / JSON_NAME).write_text(json.dumps(golden, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.glob("czi_*"))
    print("regenerated:", len(golden["files"]), "files,",
          len(golden["refused"]), "refusals,", total, "bytes")


if __name__ == "__main__":
    main()
