"""Tiled BigTIFF pyramid writer with JPEG tiles (counterpart of
``classpose_tpu/io/tiff_writer.py``).

Writes an SVS-style pyramid: tiled pages sorted large to small, each tile
a full baseline JFIF stream (compression 7, photometric YCbCr, no
``JPEGTables``) encoded by :func:`classpose_tpu_torch.io.jpeg.encode`
(libjpeg's ``jpeg_set_quality`` tables at 4:2:0), an Aperio-style
ImageDescription carrying ``|MPP = x|`` and resolution tags in px/cm.
:class:`~classpose_tpu_torch.io.tiff_reader.TiffSlide` (and OpenSlide)
open it directly; the tests and ``chip_smoke.py`` write their slides
with it.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from classpose_tpu_torch.io import jpeg

_II = b"II"


class _IFD:
    """One BigTIFF IFD under construction: tag → (type, values)."""

    def __init__(self):
        self.entries: dict[int, tuple[int, list]] = {}

    def set(self, tag: int, type_: int, values) -> None:
        if not isinstance(values, (list, tuple)):
            values = [values]
        self.entries[tag] = (type_, list(values))


_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 16: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q"}


def _write_ifd(fh, ifd: _IFD, next_offset_pos_out: list) -> int:
    """Append the IFD (and its out-of-line values) at the current end of
    file; returns the IFD's offset and records the file position of its
    next-IFD pointer."""
    fh.seek(0, 2)
    # out-of-line values first
    value_bytes: dict[int, bytes] = {}
    value_offsets: dict[int, int] = {}
    for tag, (type_, vals) in sorted(ifd.entries.items()):
        if type_ == 2:  # ascii
            data = vals[0].encode("latin-1") + b"\0"
        elif type_ == 5:  # rational
            data = b"".join(
                struct.pack("<II", int(v[0]), int(v[1])) for v in vals
            )
        else:
            data = struct.pack(
                "<" + _TYPE_FMT[type_] * len(vals), *vals
            )
        value_bytes[tag] = data
        if len(data) > 8:
            pos = fh.tell()
            if pos % 2:
                fh.write(b"\0")
                pos += 1
            value_offsets[tag] = pos
            fh.write(data)

    ifd_offset = fh.tell()
    if ifd_offset % 2:
        fh.write(b"\0")
        ifd_offset += 1
    fh.write(struct.pack("<Q", len(ifd.entries)))
    for tag, (type_, vals) in sorted(ifd.entries.items()):
        if type_ == 2:
            count = len(value_bytes[tag])
        elif type_ == 5:
            count = len(vals)
        else:
            count = len(vals)
        fh.write(struct.pack("<HHQ", tag, type_, count))
        data = value_bytes[tag]
        if len(data) > 8:
            fh.write(struct.pack("<Q", value_offsets[tag]))
        else:
            fh.write(data + b"\0" * (8 - len(data)))
    next_offset_pos_out.append(fh.tell())
    fh.write(struct.pack("<Q", 0))  # next IFD (patched later)
    return ifd_offset


def write_tiled_tiff(
    path: str | Path,
    level0: np.ndarray,
    tile: int = 512,
    quality: int = 80,
    n_levels: int | None = None,
    mpp: float = 0.25,
    description: str | None = None,
) -> Path:
    """Write an RGB uint8 array as a tiled JPEG BigTIFF pyramid.

    Levels are 2× decimations down to ≤ ``tile`` px on the short side (or
    exactly ``n_levels``). MPP is carried in an Aperio-style
    ImageDescription (``|MPP = x|``) plus resolution tags.
    """
    path = Path(path)
    level0 = np.ascontiguousarray(level0, np.uint8)
    H, W = level0.shape[:2]
    if n_levels is None:
        n_levels = 1
        s = min(H, W)
        while s // 2 >= tile:
            n_levels += 1
            s //= 2
    levels = [level0]
    for _ in range(1, n_levels):
        levels.append(levels[-1][::2, ::2])
    if description is None:
        description = (
            f"classpose-tpu synthetic pyramid|AppMag = 40|MPP = {mpp}|"
        )

    with open(path, "wb") as fh:
        # BigTIFF header: II, 43, offset size 8, pad, first-IFD offset
        fh.write(_II + struct.pack("<HHHQ", 43, 8, 0, 0))

        next_ptr_positions: list[int] = []
        ifd_offsets: list[int] = []
        for lvl, img in enumerate(levels):
            h, w = img.shape[:2]
            nty = -(-h // tile)
            ntx = -(-w // tile)
            offsets, counts = [], []
            for ty in range(nty):
                for tx in range(ntx):
                    t = img[
                        ty * tile : (ty + 1) * tile,
                        tx * tile : (tx + 1) * tile,
                    ]
                    if t.shape[0] < tile or t.shape[1] < tile:
                        full = np.zeros((tile, tile, 3), np.uint8)
                        full[: t.shape[0], : t.shape[1]] = t
                        t = full
                    data = jpeg.encode(t, quality)
                    fh.seek(0, 2)
                    pos = fh.tell()
                    if pos % 2:
                        fh.write(b"\0")
                        pos += 1
                    offsets.append(pos)
                    counts.append(len(data))
                    fh.write(data)

            ifd = _IFD()
            ifd.set(256, 4, w)
            ifd.set(257, 4, h)
            ifd.set(258, 3, [8, 8, 8])
            ifd.set(259, 3, 7)        # JPEG
            ifd.set(262, 3, 6)        # YCbCr (full JFIF streams)
            ifd.set(270, 2, description if lvl == 0
                    else f"classpose-tpu level {lvl}")
            ifd.set(277, 3, 3)
            res = (int(round(10_000.0 / mpp)), 1)  # px per cm
            ifd.set(282, 5, [res])
            ifd.set(283, 5, [res])
            ifd.set(296, 3, 3)        # centimeter
            ifd.set(322, 3, tile)
            ifd.set(323, 3, tile)
            ifd.set(324, 16, offsets)
            ifd.set(325, 16, counts)
            ifd_offsets.append(_write_ifd(fh, ifd, next_ptr_positions))

        # link the IFD chain and the header
        fh.seek(8)
        fh.write(struct.pack("<Q", ifd_offsets[0]))
        for pos, nxt in zip(next_ptr_positions[:-1], ifd_offsets[1:]):
            fh.seek(pos)
            fh.write(struct.pack("<Q", nxt))
    return path
