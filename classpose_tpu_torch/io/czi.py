"""The ZISRAW container of Zeiss ``.czi`` files, in ``struct`` and numpy:
the segments, the file header, the subblock directory, the subblocks'
pixels and the XML metadata.

Every part of the file is a segment: a 32-byte header (a 16-byte ASCII Id,
then AllocatedSize and UsedSize as int64) and its data, at 32-byte aligned
offsets. :class:`CziFile` reads

- ``ZISRAWFILE`` (at offset 0): the version, ``FilePart`` (a part other
  than 0, a multi-file CZI, raises), DirectoryPosition and
  MetadataPosition;
- ``ZISRAWDIRECTORY``: its ``DV`` entries, each 32 bytes plus 20 bytes a
  dimension (Dimension, Start, Size, StartCoordinate, StoredSize); a file
  without a directory is walked segment by segment instead, skipping
  ``DELETED`` and attachment segments;
- ``ZISRAWMETADATA``: its XML, parsed by ``xml.etree.ElementTree``;
- ``ZISRAWSUBBLOCK``: its data, which starts after a header area of
  ``max(256, 16 + entry size)`` bytes and the subblock's metadata.

:meth:`CziFile.pixels` decodes a subblock to (stored height, stored width,
channels) in the file's channel order (BGR, as libCZI returns it):
uncompressed, JpgFile (the package's ``native/jpeg.cpp``, RGB reversed),
JpgXrFile (the package's ``native/jpegxr.cpp``: a JPEG XR file whose
pixel format belongs with the pixel type, 24bppBGR for Bgr24, 48bppRGB
for Bgr48, 32bppBGRA for Bgra32, its channels in the order stored; the
decoder is held to a test-side encoder written from recall, not yet to a
ZEN-written stream, see :mod:`classpose_tpu_torch.io.jpegxr`), Zstd0
and Zstd1 (the package's ``native/zstd.cpp``; Zstd1's header byte and its
hi/lo byte packing of 16-bit planes). LZW and camera-specific
compressions raise a ``ValueError`` that names them, as does a JpgXr
stream the decoder refuses. File reads go through ``os.pread``, so reader
threads share one descriptor.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np

from classpose_tpu_torch.io import jpeg, jpegxr, zstd

SEGMENT_HEADER = 32
DV_SIZE, DIM_SIZE = 32, 20

# pixel type -> (name, channels, numpy dtype)
PIXEL_TYPES = {
    0: ("Gray8", 1, np.uint8), 1: ("Gray16", 1, np.uint16),
    2: ("Gray32Float", 1, np.float32), 3: ("Bgr24", 3, np.uint8),
    4: ("Bgr48", 3, np.uint16), 8: ("Bgr96Float", 3, np.float32),
    9: ("Bgra32", 4, np.uint8), 10: ("Gray64ComplexFloat", 2, np.float32),
    11: ("Bgr192ComplexFloat", 6, np.float32), 12: ("Gray32", 1, np.int32),
    13: ("Gray64Float", 1, np.float64),
}
UNCOMPRESSED, JPG, LZW, JPGXR, ZSTD0, ZSTD1 = 0, 1, 2, 4, 5, 6
COMPRESSIONS = {UNCOMPRESSED: "uncompressed", JPG: "JpgFile", LZW: "LZW",
                JPGXR: "JpgXrFile (JPEG XR)", ZSTD0: "Zstd0", ZSTD1: "Zstd1"}
DECODED = (UNCOMPRESSED, JPG, JPGXR, ZSTD0, ZSTD1)
# pixel type -> the JPEG XR pixel format its JpgXr subblocks hold
JPGXR_FORMATS = {3: "24bppBGR", 4: "48bppRGB", 9: "32bppBGRA"}


def compression_name(c: int) -> str:
    if c in COMPRESSIONS:
        return COMPRESSIONS[c]
    return f"camera-specific compression {c}" if c >= 1000 else \
        f"compression {c}"


def pixel_type_name(t: int) -> str:
    return PIXEL_TYPES[t][0] if t in PIXEL_TYPES else f"pixel type {t}"


@dataclass
class Dim:
    start: int
    size: int
    start_coordinate: float
    stored_size: int


@dataclass
class Subblock:
    """One directory entry: its segment's offset, pixel type, compression,
    pyramid type and dimensions by name ("X", "Y", "C", "S", "M", ...)."""
    position: int
    pixel_type: int
    compression: int
    pyramid_type: int
    file_part: int
    dims: dict[str, Dim] = field(default_factory=dict)
    order: int = 0                       # its place in the directory

    def start(self, d: str, default: int = 0) -> int:
        return self.dims[d].start if d in self.dims else default

    @property
    def rect(self) -> tuple[int, int, int, int]:
        """(x, y, w, h) in document pixels."""
        x, y = self.dims["X"], self.dims["Y"]
        return x.start, y.start, x.size, y.size

    @property
    def stored(self) -> tuple[int, int]:
        """(stored width, stored height)."""
        return self.dims["X"].stored_size, self.dims["Y"].stored_size


def _dv(b: bytes, pos: int) -> tuple[Subblock, int]:
    """The ``DV`` entry at ``pos`` of ``b``, and its size."""
    if b[pos:pos + 2] != b"DV":
        raise ValueError(f"CZI: a directory entry of schema "
                         f"{b[pos:pos + 2]!r} is not supported (only DV)")
    ptype, fpos, fpart, comp, pyr = struct.unpack_from("<iqiiB", b, pos + 2)
    (ndims,) = struct.unpack_from("<i", b, pos + 28)
    sb = Subblock(fpos, ptype, comp, pyr, fpart)
    for i in range(ndims):
        off = pos + DV_SIZE + DIM_SIZE * i
        name = b[off:off + 4].split(b"\0")[0].decode("ascii")
        start, size, coord, stored = struct.unpack_from("<iifi", b, off + 4)
        sb.dims[name] = Dim(start, size, coord, stored)
    if "X" not in sb.dims or "Y" not in sb.dims:
        raise ValueError("CZI: a subblock without X and Y dimensions")
    return sb, DV_SIZE + DIM_SIZE * ndims


class CziFile:
    """An open ``.czi``: ``subblocks`` (directory order), ``metadata`` (the
    XML root, or None) and :meth:`pixels`."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._open()
        except (struct.error, UnicodeDecodeError) as e:
            self.close()
            raise ValueError(f"CZI: {self.path} is corrupt ({e})") from None
        except BaseException:
            self.close()
            raise

    def _read(self, offset: int, n: int) -> bytes:
        b = os.pread(self._fd, n, offset)
        if len(b) != n:
            raise ValueError(f"CZI: {self.path} is truncated ({n} bytes at "
                             f"{offset})")
        return b

    def _segment(self, offset: int) -> tuple[str, int, int]:
        """(Id, AllocatedSize, UsedSize) of the segment at ``offset``."""
        h = self._read(offset, SEGMENT_HEADER)
        sid = h[:16].split(b"\0")[0].decode("ascii", "replace")
        alloc, used = struct.unpack_from("<qq", h, 16)
        return sid, alloc, used

    def _open(self) -> None:
        sid, _, _ = self._segment(0)
        if sid != "ZISRAWFILE":
            raise ValueError(f"CZI: {self.path} is not a CZI file (no "
                             f"ZISRAWFILE segment at offset 0)")
        h = self._read(SEGMENT_HEADER, 80)
        self.version = struct.unpack_from("<ii", h, 0)
        (self.file_part,) = struct.unpack_from("<i", h, 48)
        if self.file_part != 0:
            raise ValueError(f"CZI: FilePart {self.file_part}: multi-file "
                             f"CZIs are not supported")
        directory, metadata = struct.unpack_from("<qq", h, 52)
        self.subblocks = (self._directory(directory) if directory
                          else self._walk())
        for i, sb in enumerate(self.subblocks):
            sb.order = i
            if sb.file_part != 0:
                raise ValueError(f"CZI: a subblock in FilePart "
                                 f"{sb.file_part}: multi-file CZIs are not "
                                 f"supported")
        self.metadata = self._metadata(metadata) if metadata else None

    def _directory(self, offset: int) -> list[Subblock]:
        sid, alloc, used = self._segment(offset)
        if sid != "ZISRAWDIRECTORY":
            raise ValueError(f"CZI: no ZISRAWDIRECTORY segment at {offset}")
        (count,) = struct.unpack_from("<i", self._read(
            offset + SEGMENT_HEADER, 4))
        b = self._read(offset + SEGMENT_HEADER, used or alloc)
        pos, out = 128, []
        for _ in range(count):
            sb, n = _dv(b, pos)
            out.append(sb)
            pos += n
        return out

    def _walk(self) -> list[Subblock]:
        """The subblocks of a file without a directory, in file order."""
        out, offset, end = [], 0, os.fstat(self._fd).st_size
        while offset + SEGMENT_HEADER <= end:
            sid, alloc, _ = self._segment(offset)
            if sid == "ZISRAWSUBBLOCK":
                head = self._read(offset + SEGMENT_HEADER, 16 + DV_SIZE)
                (ndims,) = struct.unpack_from("<i", head, 16 + 28)
                b = self._read(offset + SEGMENT_HEADER + 16,
                               DV_SIZE + DIM_SIZE * ndims)
                sb, _ = _dv(b, 0)
                sb.position = offset
                out.append(sb)
            # DELETED, ZISRAWATTDIR, ZISRAWATTACH and the rest are skipped
            if alloc <= 0:
                break
            offset += SEGMENT_HEADER + alloc
        return out

    def _metadata(self, offset: int):
        sid, _, _ = self._segment(offset)
        if sid != "ZISRAWMETADATA":
            raise ValueError(f"CZI: no ZISRAWMETADATA segment at {offset}")
        (xml_size,) = struct.unpack_from("<i", self._read(
            offset + SEGMENT_HEADER, 4))
        xml = self._read(offset + SEGMENT_HEADER + 256, xml_size)
        try:
            return ET.fromstring(xml.split(b"\0")[0])
        except ET.ParseError as e:
            raise ValueError(f"CZI: malformed metadata XML ({e})") from None

    def _data(self, sb: Subblock) -> bytes:
        sid, _, _ = self._segment(sb.position)
        if sid != "ZISRAWSUBBLOCK":
            raise ValueError(f"CZI: no ZISRAWSUBBLOCK segment at "
                             f"{sb.position}")
        base = sb.position + SEGMENT_HEADER
        meta_size, _, data_size = struct.unpack_from("<iiq",
                                                     self._read(base, 16))
        (ndims,) = struct.unpack_from("<i", self._read(base + 16 + 28, 4))
        start = max(256, 16 + DV_SIZE + DIM_SIZE * ndims) + meta_size
        return self._read(base + start, data_size)

    def pixels(self, sb: Subblock) -> np.ndarray:
        """The subblock's stored pixels, (h, w, channels) of its pixel
        type, channels in the file's order (BGR)."""
        if sb.pixel_type not in PIXEL_TYPES:
            raise ValueError(f"CZI: {pixel_type_name(sb.pixel_type)} is not "
                             f"supported")
        if sb.compression not in DECODED:
            raise ValueError(f"CZI: {compression_name(sb.compression)} "
                             f"subblocks are not supported")
        _, ch, dtype = PIXEL_TYPES[sb.pixel_type]
        w, h = sb.stored
        if not (0 < w <= sb.rect[2] and 0 < h <= sb.rect[3]):
            raise ValueError(f"CZI: a subblock stored at {w} × {h} for "
                             f"{sb.rect[2]} × {sb.rect[3]} pixels")
        shape = (h, w, ch)
        nbytes = h * w * ch * np.dtype(dtype).itemsize
        data = self._data(sb)
        if sb.compression == JPG:
            if sb.pixel_type != 3:
                raise ValueError(f"CZI: JpgFile subblocks of "
                                 f"{pixel_type_name(sb.pixel_type)} are not "
                                 f"supported (only Bgr24)")
            rgb = jpeg.decode(data)
            if rgb.shape != shape:
                raise ValueError(f"CZI: a JpgFile subblock of {rgb.shape} "
                                 f"where the directory says {shape}")
            return np.ascontiguousarray(rgb[..., ::-1])
        if sb.compression == JPGXR:
            f = jpegxr.container(data)
            if JPGXR_FORMATS.get(sb.pixel_type) != f.pixel_format:
                raise ValueError(
                    f"CZI: a JpgXrFile subblock of {f.pixel_format} for "
                    f"{pixel_type_name(sb.pixel_type)} (which takes "
                    f"{JPGXR_FORMATS.get(sb.pixel_type, 'no JPEG XR format')})")
            px = jpegxr.decode(f)
            if px.shape != shape:
                raise ValueError(f"CZI: a JpgXrFile subblock of {px.shape} "
                                 f"where the directory says {shape}")
            return px
        if sb.compression == UNCOMPRESSED:
            if len(data) < nbytes:
                raise ValueError("CZI: an uncompressed subblock shorter "
                                 "than its pixels")
            raw = np.frombuffer(data, np.uint8, nbytes)
        elif sb.compression == ZSTD0:
            raw = zstd.decompress(data, nbytes)
        else:
            raw = self._zstd1(data, nbytes, np.dtype(dtype).itemsize)
        return raw.view(np.dtype(dtype).newbyteorder("<")).reshape(shape) \
            .astype(dtype, copy=False)

    @staticmethod
    def _zstd1(data: bytes, nbytes: int, itemsize: int) -> np.ndarray:
        """Zstd1: a header (byte 0 its size, 1 or 3; at 3, chunk 1 holds a
        flag byte whose bit 0 means hi/lo byte packing), then a zstd
        frame."""
        if not data or data[0] not in (1, 3) or len(data) < data[0]:
            raise ValueError(f"CZI: a Zstd1 header of size "
                             f"{data[0] if data else 0} (1 or 3)")
        hilo = False
        if data[0] == 3:
            if data[1] != 1:
                raise ValueError(f"CZI: a Zstd1 header chunk of type "
                                 f"{data[1]} (only 1)")
            hilo = bool(data[2] & 1)
        raw = zstd.decompress(data[data[0]:], nbytes)
        if hilo and itemsize == 2:
            half = nbytes // 2
            out = np.empty(nbytes, np.uint8)
            out[0::2], out[1::2] = raw[:half], raw[half:]
            raw = out
        return raw

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
