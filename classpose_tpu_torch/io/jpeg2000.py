"""JPEG 2000 Part-1 and HT (Part 15) decoding on the native decoder
(``native/jpeg2000.cpp``), for the Aperio tiles (TIFF compressions 33003
and 33005) of the TIFF slide reader: raw codestreams and JP2 files.

:func:`decode` returns what ``Image.open(...).convert("RGB")`` returns
with PIL 12 and its OpenJPEG 2.5, bit for bit: component precisions 1 to
31 bits (signed or not, mixed), reduced to 8 bits as PIL's unpackers do
(16 for a one-component image above 8 bits, then clipped), one or two
components replicated, a fourth dropped; subsampled components (Aperio's
4:2:0 and 4:2:2 YCbCr tiles) read at PIL's offsets and strides, as sYCC
where Cb or Cr is subsampled; in a JP2 file PIL's mode and OpenJPEG's
colour space (sRGB, greyscale, sYCC through PIL's YCbCr tables, CMYK, a
palette); packet headers in the packets or packed in PPM or PPT
segments; Part 15 (HTJ2K): its signalling (Rsiz, CAP, CPF) and HT
code-blocks, decoded as OpenJPEG decodes them. Where PIL raises (one or
two components with subsampling among them, the component transform
over components of different sizes, malformed HT blocks), for the
features the decoder refuses (listed in its source: mixed HT and Part 1
code-blocks, Part 2, more than four components) and for truncated or
corrupt streams, it raises ``ValueError`` naming what it refuses.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.native import load_jpeg2000

_ERRLEN = 256


def info(data: bytes) -> tuple[int, int, int]:
    """(height, width, components) from the SIZ marker."""
    lib = load_jpeg2000()
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.j2k_info(data, len(data), dims, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return dims[0], dims[1], dims[2]


def decode(data: bytes) -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG 2000 codestream."""
    lib = load_jpeg2000()
    h, w, _ = info(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.j2k_decode(data, len(data), out.ctypes.data, out.nbytes, err,
                      _ERRLEN):
        raise ValueError(err.value.decode())
    return out
