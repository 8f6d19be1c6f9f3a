"""Zstandard decompression on the package's own decoder
(``native/zstd.cpp``, RFC 8878), for the CZI reader's Zstd0 and Zstd1
subblocks.

:func:`decompress` decodes every frame of its input, as libzstd's
``ZSTD_decompress`` does: skippable frames are skipped, frames with and
without a content size are read, and the XXH64 content checksum is
checked where a frame carries one. A frame that names a dictionary, a
frame that needs a window above 128 MiB (libzstd's default limit), and a
corrupt or truncated frame raise ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from classpose_tpu_torch.native import load_zstd

_ERRLEN = 256


def decompress(data, size: int | None = None) -> np.ndarray:
    """The decoded bytes of ``data`` as a uint8 array. With ``size`` they
    are decoded into an array of that many bytes, and any other decoded
    size raises."""
    lib = load_zstd()
    data = bytes(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    if size is not None:
        out = np.empty(int(size), np.uint8)
        n = lib.zstd_decompress(data, len(data), out.ctypes.data, out.nbytes,
                                None, err, _ERRLEN)
        if n < 0:
            raise ValueError(f"zstd: {err.value.decode()}")
        if n != out.nbytes:
            raise ValueError(f"zstd: decoded {n} bytes where {out.nbytes} "
                             f"were expected")
        return out
    ptr = ctypes.c_void_p()
    n = lib.zstd_decompress(data, len(data), None, 0, ctypes.byref(ptr), err,
                            _ERRLEN)
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return np.frombuffer(ctypes.string_at(ptr, n) if n else b"",
                             np.uint8).copy()
    finally:
        lib.zstd_free(ptr)
