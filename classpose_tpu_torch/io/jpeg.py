"""JPEG decode and encode on the native codec (``native/jpeg.cpp``), for
the TIFF slide reader and writer.

:func:`decode` returns what PIL's ``Image.open(...).convert("RGB")``
returns (libjpeg-turbo 3.1's default decompression), bit for bit, for
every stream PIL reads: sequential and progressive Huffman (SOF0-2),
sequential and progressive arithmetic (SOF9/SOF10), lossless (SOF3),
grey, YCbCr, RGB, CMYK and YCCK, sampling factors 1 to 4, with
libjpeg's block smoothing of incomplete progressive scripts. A stream PIL
refuses raises ``ValueError`` naming the process or feature
(hierarchical processes, SOF11, DNL, 12- and 16-bit samples, fractional
sampling, ...). A damaged stream goes as it goes through PIL: one that
ends before its EOI raises ``ValueError`` where PIL raises "image file is
truncated", and corrupt entropy-coded data decodes to PIL's pixels
(libjpeg-turbo's recovery: bad codes, markers inside a scan, restart
resync, and its x86-64 SIMD inverse DCT's 16-bit limits).
:func:`encode` writes a baseline JFIF stream at 4:2:0 with the Annex K
tables scaled by ``quality`` as ``jpeg_set_quality`` scales them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.native import load_jpeg

_ERRLEN = 256


def info(data: bytes) -> tuple[int, int, int]:
    """(height, width, components) from the frame header (any process;
    4 for CMYK and YCCK)."""
    lib = load_jpeg()
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.jpeg_info(data, len(data), dims, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return dims[0], dims[1], dims[2]


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG stream of any process PIL reads
    (grey replicated, CMYK and YCCK converted as PIL converts them)."""
    lib = load_jpeg()
    h, w, _ = info(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err,
                       _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def encode(rgb: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JFIF stream (4:2:0) of an (H, W, 3) uint8 image."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8, got {rgb.shape}")
    lib = load_jpeg()
    h, w = rgb.shape[:2]
    # room for the worst case: every coefficient of every block coded at
    # full length (~5 bytes a pixel at 4:2:0), doubled for 0xFF stuffing
    out = np.empty(h * w * 10 + 65536, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.jpeg_encode(rgb.ctypes.data, h, w, int(quality), out.ctypes.data,
                        out.nbytes, err, _ERRLEN)
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n].tobytes()
