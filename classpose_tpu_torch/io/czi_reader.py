"""Zeiss CZI reader with an OpenSlide-like interface (counterpart of
``classpose_tpu/io/czi_reader.py``, the JAX package's "Zeiss CZI (JPEG-XR)
reader"), on the package's own ZISRAW parser (``io/czi.py``) and JPEG XR
decoder (``io/jpegxr.py``) instead of pylibCZIrw.

The JAX class's semantics: a 5-level synthetic pyramid with downsamples
(1, 2, 4, 8, 16) over reads at zoom ``1 / downsample``, the document
origin at the bounding rectangle of all subblocks (which may be
negative), MPP from ``Scaling/Items/Distance[@Id="X"]/Value`` in metres
(stored as ``str(value * 1e6)``; no property without it), BGR → RGB, and
an edge tile resized to the request by Pillow's default resampling
(``io/pil_resize.py``).

A read takes the plane C = Z = T = 0 of every scene, as pylibCZIrw reads
it when no plane is given. At zoom 1 it composes layer 0's subblocks in
M-index order, later ones on top. At zoom < 1 it takes the pyramid layer
with the smallest zoom at or above the requested one (a subblock's zoom is
StoredSize / Size; each stored pixel covers its Size / StoredSize block of
document pixels), over the request clamped to the bounding rectangle, and
scales that nearest-neighbour to ``round(size * zoom)`` as PIL's
``NEAREST`` maps pixels. Bgr24 and Bgra32 give RGB; Bgr48 keeps the low
byte of each sample (the JAX reader's ``astype(np.uint8)``); grey and
float pixel types raise a ``ValueError`` that names them, as do the
compressions ``io/czi.py`` refuses. Decoded subblocks are cached; reads
are safe from several threads.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import numpy as np

from classpose_tpu_torch.io import pil_resize
from classpose_tpu_torch.io.czi import (
    DECODED,
    JPGXR,
    CziFile,
    compression_name,
    pixel_type_name,
)

logger = logging.getLogger(__name__)

_DOWNSAMPLES = (1, 2, 4, 8, 16)
_RGB_TYPES = (3, 4, 9)              # Bgr24, Bgr48, Bgra32
_CELL = 1024                        # spatial index cell, document pixels
CACHE_BYTES = 256 << 20             # decoded subblocks kept per slide


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel of PIL's ``NEAREST`` resize
    (``ImagingScaleAffine``: the position accumulated by repeated
    addition, then truncated)."""
    step = float(in_size) / out_size
    pos = np.full(out_size, step)
    pos[0] = 0.0 + step * 0.5
    return np.add.accumulate(pos).astype(np.int64)


class _Layer:
    """The subblocks of one pyramid layer of the plane read, with a grid
    index over their rectangles."""

    def __init__(self, blocks: list):
        self.blocks = sorted(blocks, key=lambda b: (b.start("M", -1),
                                                    b.order))
        self.grid: dict[tuple[int, int], list[int]] = {}
        for i, b in enumerate(self.blocks):
            x, y, w, h = b.rect
            for gy in range(y // _CELL, (y + h - 1) // _CELL + 1):
                for gx in range(x // _CELL, (x + w - 1) // _CELL + 1):
                    self.grid.setdefault((gx, gy), []).append(i)

    def overlapping(self, x0: int, y0: int, x1: int, y1: int) -> list:
        """The subblocks meeting [x0, x1) × [y0, y1), in drawing order."""
        found = set()
        for gy in range(y0 // _CELL, (y1 - 1) // _CELL + 1):
            for gx in range(x0 // _CELL, (x1 - 1) // _CELL + 1):
                found.update(self.grid.get((gx, gy), ()))
        out = []
        for i in sorted(found):
            x, y, w, h = self.blocks[i].rect
            if x < x1 and x + w > x0 and y < y1 and y + h > y0:
                out.append(self.blocks[i])
        return out


class CZISlide:
    def __init__(self, path: str):
        self._file = CziFile(path)
        try:
            self._setup()
        except BaseException:
            self._file.close()
            raise
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cached = 0
        self._lock = threading.Lock()

    def _setup(self) -> None:
        blocks = self._file.subblocks
        if not blocks:
            raise ValueError("CZI: the file holds no subblocks")
        x0 = min(b.rect[0] for b in blocks)
        y0 = min(b.rect[1] for b in blocks)
        x1 = max(b.rect[0] + b.rect[2] for b in blocks)
        y1 = max(b.rect[1] + b.rect[3] for b in blocks)
        self._x0, self._y0, self._x1, self._y1 = x0, y0, x1, y1
        W, H = x1 - x0, y1 - y0
        self.level_count = len(_DOWNSAMPLES)
        self.level_downsamples = tuple(float(d) for d in _DOWNSAMPLES)
        self.level_dimensions = tuple(
            (max(1, W // d), max(1, H // d)) for d in _DOWNSAMPLES)
        self.dimensions = self.level_dimensions[0]
        self.properties = {}
        mpp = self._resolve_mpp()
        if mpp:
            self.properties["openslide.mpp-x"] = str(mpp)
            self.properties["openslide.mpp-y"] = str(mpp)

        plane = [b for b in blocks
                 if all(b.start(d) == 0 for d in ("C", "Z", "T"))]
        if not plane:
            raise ValueError("CZI: no subblock of the plane C = Z = T = 0")
        types = {b.pixel_type for b in plane}
        if len(types) > 1:
            raise ValueError(f"CZI: subblocks of several pixel types "
                             f"({sorted(pixel_type_name(t) for t in types)})")
        self.pixel_type = types.pop()
        if self.pixel_type not in _RGB_TYPES:
            raise ValueError(f"CZI: {pixel_type_name(self.pixel_type)} "
                             f"slides are not supported (Bgr24, Bgr48 and "
                             f"Bgra32 are)")
        for b in plane:
            if b.compression not in DECODED:
                raise ValueError(f"CZI: {compression_name(b.compression)} "
                                 f"subblocks are not supported")
        if any(b.compression == JPGXR for b in plane):
            logger.warning(
                "CZI: JpgXrFile subblocks are read by the package's JPEG XR "
                "decoder, which is held to a test-side encoder and not yet "
                "to ZEN- or jxrlib-written streams: a stream it misreads "
                "mostly raises, but may decode to other pixels")
        by_factor: dict[int, list] = {}
        for b in plane:
            (sw, _), w = b.stored, b.rect[2]
            factor = max(1, int(round(w / sw))) if sw else 1
            by_factor.setdefault(factor, []).append(b)
        if 1 not in by_factor:
            raise ValueError("CZI: no subblock at zoom 1 (layer 0)")
        # doc pixels per stored pixel -> that pyramid layer
        self._layers = {f: _Layer(bs) for f, bs in by_factor.items()}

    def _resolve_mpp(self) -> float | None:
        root = self._file.metadata
        items = None if root is None else root.find("Metadata/Scaling/Items")
        if root is None or root.tag != "ImageDocument" or items is None:
            logger.warning("could not resolve MPP from CZI metadata")
            return None
        try:
            for item in items.findall("Distance"):
                if item.get("Id") in ("X", "x"):
                    return float(item.find("Value").text) * 1e6
        except (TypeError, ValueError, AttributeError):
            logger.warning("could not resolve MPP from CZI metadata")
        return None

    def _pixels(self, b) -> np.ndarray:
        key = b.position
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        arr = self._file.pixels(b)
        with self._lock:
            if key not in self._cache:
                self._cache[key] = arr
                self._cached += arr.nbytes
                while self._cached > CACHE_BYTES and \
                        len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._cached -= old.nbytes
        return arr

    def _read(self, roi, zoom: float) -> np.ndarray:
        """pylibCZIrw's ``read(roi=(x, y, w, h), zoom=zoom)`` of the plane
        C = Z = T = 0, BGR(A) in the pixel type's dtype."""
        x, y, w, h = roi
        xs, ys = max(x, self._x0), max(y, self._y0)
        xe, ye = min(x + w, self._x1), min(y + h, self._y1)
        if xe <= xs or ye <= ys:
            raise ValueError(f"CZI: the region {roi} lies outside the "
                             f"slide")
        cw, ch = xe - xs, ye - ys
        ow = max(1, int(round(cw * zoom)))
        oh = max(1, int(round(ch * zoom)))
        factor = max(f for f in self._layers if 1.0 / f >= zoom - 1e-12)
        layer = self._layers[factor]
        # the document pixel each output pixel shows
        cols = xs + (nearest_index(cw, ow) if ow != cw else np.arange(cw))
        rows = ys + (nearest_index(ch, oh) if oh != ch else np.arange(ch))
        blocks = layer.overlapping(xs, ys, xe, ye)
        nch = 4 if self.pixel_type == 9 else 3
        dtype = np.uint16 if self.pixel_type == 4 else np.uint8
        out = np.zeros((oh, ow, nch), dtype)
        for b in blocks:
            bx, by, bw, bh = b.rect
            sw, sh = b.stored
            ci = np.nonzero((cols >= bx) & (cols < bx + bw))[0]
            ri = np.nonzero((rows >= by) & (rows < by + bh))[0]
            if not len(ci) or not len(ri):
                continue
            px = self._pixels(b)
            sc = (cols[ci] - bx) * sw // bw
            sr = (rows[ri] - by) * sh // bh
            c0, r0 = ci[0], ri[0]
            if sw == bw and sh == bh and ow == cw and oh == ch:
                out[r0:r0 + len(ri), c0:c0 + len(ci)] = \
                    px[sr[0]:sr[0] + len(sr), sc[0]:sc[0] + len(sc)]
            else:
                out[np.ix_(ri, ci)] = px[np.ix_(sr, sc)]
        return out

    def read_region(self, location, level, size) -> np.ndarray:
        """(h, w, 4) uint8 RGBA (alpha 255) at ``level`` from level-0
        ``location``."""
        x0, y0 = location
        w, h = size
        ds = int(self.level_downsamples[level])
        roi = (self._x0 + int(x0), self._y0 + int(y0), int(w * ds),
               int(h * ds))
        arr = self._read(roi, 1.0 / ds)
        rgb = arr[..., [2, 1, 0]].astype(np.uint8)
        out = np.empty(rgb.shape[:2] + (4,), np.uint8)
        out[..., :3] = rgb
        out[..., 3] = 255
        if out.shape[:2] != (h, w):
            out = pil_resize.resize(out, (w, h))
        return out

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, ds in enumerate(self.level_downsamples):
            if ds <= downsample + 1e-9:
                best = i
        return best

    def get_thumbnail(self, size) -> np.ndarray:
        """RGB of the coarsest level, subsampled with a stride to fit
        within ``size`` (w, h), as the package's ``TiffSlide`` does."""
        lv = self.level_count - 1
        w, h = self.level_dimensions[lv]
        img = self.read_region((0, 0), lv, (w, h))[..., :3]
        step = max(1, int(np.ceil(max(w / size[0], h / size[1]))))
        return np.ascontiguousarray(img[::step, ::step])

    def close(self):
        self._file.close()
