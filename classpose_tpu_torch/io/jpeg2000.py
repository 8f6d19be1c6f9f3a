"""JPEG 2000 Part-1 codestream decoding on the native decoder
(``native/jpeg2000.cpp``), for the Aperio tiles (TIFF compressions 33003
and 33005) of the TIFF slide reader.

:func:`decode` returns what ``Image.open(...).convert("RGB")`` returns
with PIL's OpenJPEG 2.5, bit for bit: one or two components are
replicated, a fourth is dropped, signed components are shifted by 128.
Raw codestreams only: a JP2-boxed file raises ``ValueError``, as do the
features the decoder refuses (listed in its source) and truncated or
corrupt streams.
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
