"""JPEG XR (ITU-T T.832 | ISO/IEC 29199-2) files on the native decoder
(``native/jpegxr.cpp``), for the CZI reader's JpgXr subblocks.

The file container is tag based: ``II`` 0xBC 0x01, the offset of the
first IFD, and IFD entries of 12 bytes. :func:`container` reads
``PixelFormat`` (a GUID), the width and height, the image offset and
byte count, and the alpha offset and byte count (an alpha plane stored as
a second codestream); other tags are skipped. :func:`decode` returns
(H, W, C) uint8 or uint16 in the channel order the pixel format stores:
24bppBGR, 24bppRGB, 32bppBGRA, 48bppRGB, 8bppGray and 16bppGray. Every
other pixel format, and every codestream feature the decoder refuses
(listed in its source), raises a ``ValueError`` that names it, as does a
truncated or corrupt file.

The decoder is held to a test-side encoder (``tests/golden/
regenerate_jxr.py``), not to jxrlib: both were written from the
standard's structure as recalled, without its text or jxrlib's source,
so the VLC tables, the coefficient syntax, the transforms' slot order and
the overlap filter's lifting steps are unverified against ZEN-written
streams. Each tile packet must decode within its span of the index table
and end there, so most streams written with another syntax raise.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np

from classpose_tpu_torch.native import load_jpegxr

_ERRLEN = 256
GUID_PREFIX = bytes.fromhex("24C3DD6F034EFE4BB1853D77768DC9")
# the last GUID byte -> (name, channels, dtype, channel order)
FORMATS = {
    0x08: ("8bppGray", 1, np.uint8, "Y"),
    0x0B: ("16bppGray", 1, np.uint16, "Y"),
    0x0C: ("24bppBGR", 3, np.uint8, "BGR"),
    0x0D: ("24bppRGB", 3, np.uint8, "RGB"),
    0x0F: ("32bppBGRA", 4, np.uint8, "BGRA"),
    0x15: ("48bppRGB", 3, np.uint16, "RGB"),
}
# pixel formats of the standard that are refused, by name
REFUSED = {
    0x05: "BlackWhite", 0x09: "16bppBGR555", 0x0A: "16bppBGR565",
    0x0E: "32bppBGR", 0x10: "32bppPBGRA", 0x11: "32bppGrayFloat",
    0x12: "48bppRGBFixedPoint", 0x13: "16bppGrayFixedPoint",
    0x14: "32bppBGR101010", 0x16: "64bppRGBA", 0x17: "64bppPRGBA",
    0x18: "96bppRGBFixedPoint", 0x19: "128bppRGBAFloat",
    0x1A: "128bppPRGBAFloat", 0x1B: "128bppRGBFloat", 0x1C: "32bppCMYK",
    0x1D: "64bppRGBAFixedPoint", 0x1E: "128bppRGBAFixedPoint",
    0x1F: "64bppCMYK", 0x20: "24bpp3Channels", 0x2C: "40bppCMYKAlpha",
    0x3B: "48bppRGBHalf", 0x3D: "32bppRGBE", 0x3E: "16bppGrayHalf",
    0x3F: "32bppGrayFixedPoint",
}
TAG_PIXEL_FORMAT, TAG_WIDTH, TAG_HEIGHT = 0xBC01, 0xBC80, 0xBC81
TAG_IMAGE_OFFSET, TAG_IMAGE_BYTES = 0xBCC0, 0xBCC1
TAG_ALPHA_OFFSET, TAG_ALPHA_BYTES = 0xBCC2, 0xBCC3
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 6: 1, 7: 1, 8: 2, 9: 4, 11: 4, 12: 8,
          16: 8}


def _tags(data: bytes) -> dict[int, bytes]:
    """Each IFD entry's value bytes, by tag."""
    if data[:4] != b"II\xbc\x01":
        raise ValueError("JPEG XR: not a JPEG XR file (no II BC 01 header)")
    try:
        (ifd,) = struct.unpack_from("<I", data, 4)
        (n,) = struct.unpack_from("<H", data, ifd)
        out = {}
        for k in range(n):
            tag, typ, cnt, val = struct.unpack_from("<HHII", data,
                                                    ifd + 2 + 12 * k)
            size = _SIZES.get(typ, 1) * cnt
            if size <= 4:
                out[tag] = data[ifd + 10 + 12 * k:ifd + 10 + 12 * k + size]
            else:
                if val + size > len(data):
                    raise ValueError(f"JPEG XR: tag {tag:#06x} past the "
                                     f"file")
                out[tag] = data[val:val + size]
        return out
    except struct.error:
        raise ValueError("JPEG XR: a truncated IFD") from None


def _uint(tags: dict, tag: int, name: str) -> int:
    if tag not in tags:
        raise ValueError(f"JPEG XR: no {name} tag")
    b = tags[tag]
    if len(b) not in (1, 2, 4):
        raise ValueError(f"JPEG XR: a {name} tag of {len(b)} bytes")
    return int.from_bytes(b, "little")


class Container(NamedTuple):
    """A JPEG XR file's container: its pixel format's name (a GUID's text
    where the standard's table has none), its size and its codestreams."""
    pixel_format: str
    width: int
    height: int
    image: bytes
    alpha: bytes | None


def container(data) -> Container:
    """Parse the tag-based container, whatever its pixel format."""
    data = bytes(data)
    tags = _tags(data)
    g = tags.get(TAG_PIXEL_FORMAT, b"")
    if len(g) != 16:
        raise ValueError("JPEG XR: no PixelFormat GUID")
    last = g[15] if g[:15] == GUID_PREFIX else None
    name = (FORMATS[last][0] if last in FORMATS else REFUSED.get(last)) \
        or _guid_text(g)
    w = _uint(tags, TAG_WIDTH, "ImageWidth")
    h = _uint(tags, TAG_HEIGHT, "ImageHeight")

    def stream(off_tag, n_tag, name):
        off = _uint(tags, off_tag, f"{name}Offset")
        n = _uint(tags, n_tag, f"{name}ByteCount")
        if off + n > len(data) or n == 0:
            raise ValueError(f"JPEG XR: the {name.lower()} codestream is "
                             f"past the file")
        return data[off:off + n]

    image = stream(TAG_IMAGE_OFFSET, TAG_IMAGE_BYTES, "Image")
    alpha = stream(TAG_ALPHA_OFFSET, TAG_ALPHA_BYTES, "Alpha") \
        if TAG_ALPHA_OFFSET in tags else None
    return Container(name, w, h, image, alpha)


def _format(c: Container) -> tuple:
    """(name, channels, dtype, channel order) of a pixel format read."""
    for f in FORMATS.values():
        if f[0] == c.pixel_format:
            return f
    raise ValueError(f"JPEG XR: pixel format {c.pixel_format} is not "
                     f"supported (only "
                     + ", ".join(f[0] for f in FORMATS.values()) + ")")


def _guid_text(g: bytes) -> str:
    d1, d2, d3 = struct.unpack_from("<IHH", g)
    return (f"{{{d1:08X}-{d2:04X}-{d3:04X}-{g[8:10].hex().upper()}-"
            f"{g[10:].hex().upper()}}}")


def codestream_info(cs: bytes) -> tuple[int, int, int, int]:
    """(height, width, channels, bytes per sample) of a codestream."""
    lib = load_jpegxr()
    dims = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.jxr_info(cs, len(cs), dims, err, _ERRLEN):
        raise ValueError(f"JPEG XR: {err.value.decode()}")
    return dims[0], dims[1], dims[2], dims[3]


def decode_codestream(cs: bytes) -> np.ndarray:
    """(H, W, C) samples of a codestream: Y, or R, G, B, with the alpha
    image plane last."""
    cs = bytes(cs)
    h, w, c, nb = codestream_info(cs)
    out = np.empty((h, w, c), np.uint8 if nb == 1 else np.uint16)
    err = ctypes.create_string_buffer(_ERRLEN)
    if load_jpegxr().jxr_decode(cs, len(cs), out.ctypes.data, out.nbytes,
                                err, _ERRLEN):
        raise ValueError(f"JPEG XR: {err.value.decode()}")
    return out


def info(data) -> tuple[int, int, int, str]:
    """(height, width, channels, pixel format name) from the container."""
    c = container(data)
    name, ch, _, _ = _format(c)
    return c.height, c.width, ch, name


def decode(data) -> np.ndarray:
    """(H, W, C) of a JPEG XR file, given as its bytes or its
    :func:`container`, in its pixel format's channel order."""
    c = data if isinstance(data, Container) else container(data)
    name, ch, dtype, order = _format(c)
    w, h = c.width, c.height
    px = decode_codestream(c.image)
    nb = np.dtype(dtype).itemsize
    want = 3 if ch >= 3 else 1
    if c.alpha is None and "A" in order:
        want = 4
    if px.shape != (h, w, want) or px.itemsize != nb:
        raise ValueError(f"JPEG XR: a codestream of {px.shape} "
                         f"{px.dtype} for {name} at {w} x {h}")
    if c.alpha is not None:
        if "A" not in order:
            raise ValueError(f"JPEG XR: an alpha codestream with {name}")
        a = decode_codestream(c.alpha)
        if a.shape != (h, w, 1) or a.itemsize != nb:
            raise ValueError(f"JPEG XR: an alpha codestream of {a.shape} "
                             f"{a.dtype} for {w} x {h}")
        px = np.concatenate([px, a], -1)
    src = "RGBA"[:px.shape[-1]] if ch >= 3 else "Y"
    return np.ascontiguousarray(px[..., [src.index(k) for k in order]])
