"""Tiled/striped TIFF (BigTIFF, Aperio SVS) slide reader (counterpart of
``classpose_tpu/io/tiff_reader.py``).

Random access is per tile: only the tiles covering a requested region
are read and decoded (256 of them kept in an LRU cache), so 100k × 100k
slides never sit whole in memory. Raw reads on the shared file handle
are serialized; decoding is not, so the slide loader's reader threads
decode in parallel (the JPEG and JPEG 2000 decoders are native code
called with the GIL released).

Supported: classic and BigTIFF, both byte orders, tiled and striped
pages, compressions none (1), LZW (5), JPEG (7, merging the page's
``JPEGTables``, decoded by :mod:`classpose_tpu_torch.io.jpeg` bit for
bit as PIL's libjpeg-turbo decodes: baseline, progressive, arithmetic and
lossless tiles, any sampling factors, CMYK), Deflate (8, 32946), Aperio JPEG 2000 (33003,
33005: raw codestreams decoded by :mod:`classpose_tpu_torch.io.jpeg2000`
bit for bit as PIL's OpenJPEG decodes them; the components go out as
coded, so a 33003 tile whose codestream holds Y, Cb, Cr without the MCT
flag gives those values, as the reference reader's PIL call does), the
horizontal predictor (2), photometric RGB and YCbCr. Pyramid levels are
the pages of the base's aspect sorted by area; the MPP comes from the
Aperio ImageDescription (``|MPP = x``) or the resolution tags.

Regions and thumbnails are numpy arrays, as
:class:`~classpose_tpu_torch.io.array_reader.ArraySlide` returns them.
"""

from __future__ import annotations

import struct
import threading
import zlib
from functools import lru_cache

import numpy as np

from classpose_tpu_torch.io import jpeg, jpeg2000
from classpose_tpu_torch.log import get_logger

logger = get_logger(__name__)

# TIFF tag ids
_TAGS = {
    256: "width", 257: "height", 258: "bits", 259: "compression",
    262: "photometric", 270: "description", 273: "strip_offsets",
    277: "spp", 278: "rows_per_strip", 279: "strip_counts",
    282: "xres", 283: "yres", 296: "res_unit", 317: "predictor",
    322: "tile_width", 323: "tile_height", 324: "tile_offsets",
    325: "tile_counts", 339: "sample_format", 347: "jpeg_tables",
    530: "ycbcr_subsampling",
}

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 16: "Q", 17: "q"}


class _Page:
    __slots__ = (
        "width", "height", "tile_width", "tile_height", "compression",
        "photometric", "spp", "offsets", "counts", "rows_per_strip",
        "tiled", "predictor", "jpeg_tables", "description", "xres", "yres",
        "res_unit", "bits",
    )


class TiffSlide:
    """OpenSlide-compatible reader over a tiled/striped (Big)TIFF."""

    def __init__(self, path: str, tile_cache: int = 256):
        self._path = path
        self._fh = open(path, "rb")
        # read_region is called from concurrent reader threads; raw
        # seek+read on the shared handle must be serialized
        self._io_lock = threading.Lock()
        self._parse_header()
        self._pages = self._parse_pages()
        if not self._pages:
            raise ValueError(f"no images found in {path}")
        # pyramid = pages sorted by area desc, keeping only pages that look
        # like downsamples of the base (aspect within 5%); others (labels,
        # macros) are ignored like openslide's associated images
        base = max(self._pages, key=lambda p: p.width * p.height)
        ar = base.width / base.height
        levels = [
            p for p in self._pages
            if abs((p.width / p.height) - ar) / ar < 0.05
        ]
        levels.sort(key=lambda p: -(p.width * p.height))
        self._levels = levels
        self.level_count = len(levels)
        self.level_dimensions = tuple((p.width, p.height) for p in levels)
        self.dimensions = self.level_dimensions[0]
        self.level_downsamples = tuple(
            ((base.width / p.width) + (base.height / p.height)) / 2
            for p in levels
        )
        self.properties = self._build_properties(base)
        self._decode_tile = lru_cache(maxsize=tile_cache)(self._decode_tile_u)

    # ------------------------------------------------------------- parsing
    def _parse_header(self):
        fh = self._fh
        fh.seek(0)
        order = fh.read(2)
        if order == b"II":
            self._e = "<"
        elif order == b"MM":
            self._e = ">"
        else:
            raise ValueError("not a TIFF file")
        magic = struct.unpack(self._e + "H", fh.read(2))[0]
        if magic == 42:
            self._big = False
            self._first_ifd = struct.unpack(self._e + "I", fh.read(4))[0]
        elif magic == 43:
            self._big = True
            fh.read(4)  # offset size + pad
            self._first_ifd = struct.unpack(self._e + "Q", fh.read(8))[0]
        else:
            raise ValueError(f"bad TIFF magic {magic}")

    def _read_value(self, type_, count, raw):
        size = _TYPE_SIZES.get(type_, 1) * count
        off_size = 8 if self._big else 4
        if size > off_size:
            offset = struct.unpack(
                self._e + ("Q" if self._big else "I"), raw[:off_size]
            )[0]
            pos = self._fh.tell()
            self._fh.seek(offset)
            data = self._fh.read(size)
            self._fh.seek(pos)
        else:
            data = raw[:size]
        if type_ == 2:
            return data.split(b"\0")[0].decode("latin-1", "replace")
        if type_ in (5, 10):  # rational
            fmt = self._e + ("II" if type_ == 5 else "ii") * count
            vals = struct.unpack(fmt, data)
            return tuple(
                vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                for i in range(0, len(vals), 2)
            )
        if type_ == 7:  # undefined bytes
            return data
        fmt_ch = _TYPE_FMT.get(type_)
        if fmt_ch is None:
            return data
        vals = struct.unpack(self._e + fmt_ch * count, data)
        return vals if count > 1 else vals[0]

    def _parse_pages(self):
        fh = self._fh
        pages = []
        offset = self._first_ifd
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            fh.seek(offset)
            if self._big:
                n = struct.unpack(self._e + "Q", fh.read(8))[0]
                entry_size = 20
            else:
                n = struct.unpack(self._e + "H", fh.read(2))[0]
                entry_size = 12
            entries = fh.read(entry_size * n)
            tags = {}
            for i in range(n):
                e = entries[i * entry_size : (i + 1) * entry_size]
                tag, type_ = struct.unpack(self._e + "HH", e[:4])
                if self._big:
                    count = struct.unpack(self._e + "Q", e[4:12])[0]
                    raw = e[12:20]
                else:
                    count = struct.unpack(self._e + "I", e[4:8])[0]
                    raw = e[8:12]
                name = _TAGS.get(tag)
                if name:
                    tags[name] = self._read_value(type_, count, raw)
            nxt_pos = offset + (8 if self._big else 2) + entry_size * n
            fh.seek(nxt_pos)
            offset = struct.unpack(
                self._e + ("Q" if self._big else "I"),
                fh.read(8 if self._big else 4),
            )[0]
            if "width" not in tags or "height" not in tags:
                continue
            p = _Page()
            p.width = int(_scalar(tags["width"]))
            p.height = int(_scalar(tags["height"]))
            p.compression = int(_scalar(tags.get("compression", 1)))
            p.photometric = int(_scalar(tags.get("photometric", 2)))
            p.spp = int(_scalar(tags.get("spp", 3)))
            p.predictor = int(_scalar(tags.get("predictor", 1)))
            p.jpeg_tables = tags.get("jpeg_tables")
            p.description = tags.get("description", "")
            p.xres = tags.get("xres")
            p.yres = tags.get("yres")
            p.res_unit = int(_scalar(tags.get("res_unit", 2)))
            p.bits = tags.get("bits", 8)
            if "tile_offsets" in tags:
                p.tiled = True
                p.tile_width = int(_scalar(tags["tile_width"]))
                p.tile_height = int(_scalar(tags["tile_height"]))
                p.offsets = _as_tuple(tags["tile_offsets"])
                p.counts = _as_tuple(tags["tile_counts"])
                p.rows_per_strip = None
            elif "strip_offsets" in tags:
                p.tiled = False
                p.offsets = _as_tuple(tags["strip_offsets"])
                p.counts = _as_tuple(tags.get("strip_counts", ()))
                p.rows_per_strip = int(
                    _scalar(tags.get("rows_per_strip", p.height))
                )
                p.tile_width = p.width
                p.tile_height = p.rows_per_strip
            else:
                continue
            pages.append(p)
        return pages

    def _build_properties(self, base: _Page) -> dict:
        props = {"tiff.ImageDescription": base.description or ""}
        mpp = None
        desc = base.description or ""
        # Aperio SVS: "...|MPP = 0.4990|..."
        for part in desc.replace("\n", "|").split("|"):
            part = part.strip()
            if part.upper().startswith("MPP"):
                try:
                    mpp = float(part.split("=")[1].strip())
                except (IndexError, ValueError):
                    pass
        if mpp is None and base.xres:
            xr = _scalar(base.xres)
            if xr and xr > 0:
                if base.res_unit == 3:  # centimeter
                    mpp = 10_000.0 / xr
                elif base.res_unit == 2:  # inch
                    mpp = 25_400.0 / xr
                props["tiff.XResolution"] = str(xr)
                props["tiff.ResolutionUnit"] = (
                    "centimeter" if base.res_unit == 3 else "inch"
                )
        if mpp is not None and 0 < mpp < 100:
            props["openslide.mpp-x"] = str(mpp)
            props["openslide.mpp-y"] = str(mpp)
        return props

    # ------------------------------------------------------------- decoding
    def _decode_tile_u(self, level: int, tile_idx: int) -> np.ndarray:
        p = self._levels[level]
        offset = p.offsets[tile_idx]
        count = (
            p.counts[tile_idx]
            if tile_idx < len(p.counts)
            else None
        )
        with self._io_lock:
            self._fh.seek(offset)
            data = self._fh.read(count)
        th, tw = p.tile_height, p.tile_width
        if not p.tiled:
            # last strip may be short
            rows = min(th, p.height - tile_idx * p.rows_per_strip)
        else:
            rows = th
        comp = p.compression
        if comp == 1:
            arr = np.frombuffer(
                data, np.uint8, count=rows * tw * p.spp
            ).reshape(rows, tw, p.spp)
        elif comp in (8, 32946):
            raw = zlib.decompress(data)
            arr = _apply_predictor(
                np.frombuffer(raw, np.uint8)[: rows * tw * p.spp]
                .reshape(rows, tw, p.spp),
                p.predictor,
            )
        elif comp == 5:
            raw = _lzw_decode(data)
            arr = _apply_predictor(
                np.frombuffer(raw, np.uint8)[: rows * tw * p.spp]
                .reshape(rows, tw, p.spp),
                p.predictor,
            )
        elif comp == 7:
            arr = jpeg.decode(_merge_jpeg_tables(p.jpeg_tables, data))
        elif comp in (33003, 33005):  # Aperio JPEG 2000 (YCbCr / RGB)
            arr = jpeg2000.decode(data)
        else:
            raise NotImplementedError(f"TIFF compression {comp}")
        if arr.shape[0] < th or arr.shape[1] < tw:
            pad = np.zeros((th, tw, arr.shape[2]), np.uint8)
            pad[: arr.shape[0], : arr.shape[1]] = arr
            arr = pad
        if arr.shape[2] > 3:
            arr = arr[..., :3]
        elif arr.shape[2] == 1:
            arr = np.repeat(arr, 3, axis=2)
        return arr

    def _read_level_region(
        self, level: int, x: int, y: int, w: int, h: int
    ) -> np.ndarray:
        p = self._levels[level]
        out = np.zeros((h, w, 3), np.uint8)
        tw, th = p.tile_width, p.tile_height
        ncols = (p.width + tw - 1) // tw if p.tiled else 1
        ty0, ty1 = max(0, y) // th, max(0, min(y + h, p.height) - 1) // th
        tx0, tx1 = max(0, x) // tw, max(0, min(x + w, p.width) - 1) // tw
        if y + h <= 0 or x + w <= 0 or y >= p.height or x >= p.width:
            return out
        for ty in range(ty0, ty1 + 1):
            for tx in range(tx0, tx1 + 1):
                idx = ty * ncols + tx
                if idx >= len(p.offsets):
                    continue
                tile = self._decode_tile(level, idx)
                sy, sx = ty * th, tx * tw
                oy0 = max(sy, y) - y
                ox0 = max(sx, x) - x
                iy0 = max(sy, y) - sy
                ix0 = max(sx, x) - sx
                cy = min(sy + th, y + h, p.height) - max(sy, y)
                cx = min(sx + tw, x + w, p.width) - max(sx, x)
                if cy > 0 and cx > 0:
                    out[oy0 : oy0 + cy, ox0 : ox0 + cx] = tile[
                        iy0 : iy0 + cy, ix0 : ix0 + cx
                    ]
        return out

    # ----------------------------------------------------------- public API
    def read_region(self, location, level, size) -> np.ndarray:
        """(h, w, 4) uint8 RGBA at ``level`` from level-0 ``location``;
        outside the slide is black with alpha 255."""
        x0, y0 = location  # level-0 coordinates
        ds = self.level_downsamples[level]
        lx, ly = int(x0 / ds), int(y0 / ds)
        w, h = size
        rgb = self._read_level_region(level, lx, ly, w, h)
        return np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 1e-9:
                best = i
        return best

    def get_thumbnail(self, size) -> np.ndarray:
        """RGB of the coarsest level, subsampled to fit within ``size``
        (w, h) with its aspect ratio kept (as ``ArraySlide`` does)."""
        lv = self.level_count - 1
        w, h = self.level_dimensions[lv]
        img = self._read_level_region(lv, 0, 0, w, h)
        step = max(1, int(np.ceil(max(w / size[0], h / size[1]))))
        return np.ascontiguousarray(img[::step, ::step])

    def close(self):
        self._fh.close()


def _scalar(v):
    if isinstance(v, (tuple, list)):
        return v[0]
    return v


def _as_tuple(v):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,)


def _apply_predictor(arr: np.ndarray, predictor: int) -> np.ndarray:
    if predictor == 2:
        return np.cumsum(arr.astype(np.uint32), axis=1).astype(np.uint8)
    return arr


def _merge_jpeg_tables(tables: bytes | None, data: bytes) -> bytes:
    """Merge the page-level JPEGTables (DQT/DHT) into an abbreviated
    per-tile JPEG stream (TIFF-TechNote2 semantics)."""
    if not tables or len(tables) <= 4:
        return data
    # tables: FFD8 ... FFD9 ; data: FFD8 <frame> ... insert tables after SOI
    body = tables[2:-2]
    if data[:2] != b"\xff\xd8":
        return data
    return b"\xff\xd8" + body + data[2:]


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange=1)."""
    result = bytearray()
    clear, eoi = 256, 257
    dict_base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(dict_base)
    bitpos = 0
    nbits = 9
    prev = None
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(
            data[byte_idx : byte_idx + 4].ljust(4, b"\0"), "big"
        )
        code = (chunk >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == clear:
            table = list(dict_base)
            nbits = 9
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        result += entry
        prev = entry
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(result)
