"""The native host cores, built on first use: the geometry core
(``geomfast.cpp``), the JPEG codec of the slide reader and writer
(``jpeg.cpp``), the JPEG 2000 decoder of the slide reader
(``jpeg2000.cpp``), the lzf and szip filters of the HDF5 reader
(``hdf5filters.cpp``), and the zstd and JPEG XR decoders of the CZI
reader (``zstd.cpp``, ``jpegxr.cpp``).

:func:`load_geomfast`, :func:`load_jpeg`, :func:`load_jpeg2000`,
:func:`load_hdf5filters`, :func:`load_zstd` and :func:`load_jpegxr`
compile their source with
``g++`` into ``classpose_tpu_torch/_build/`` (the kernels' build directory,
which git ignores), named by a hash of the source and the flags, and load
it with ``ctypes`` (whose calls release the GIL, so reader threads decode
in parallel). Nothing happens at import. A build or load failure raises:
the package has no slower fallback for contours, metrics, containment,
deduplication, JPEG or JPEG 2000 tiles, lzf and szip chunks, or zstd
and JPEG XR subblocks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "geomfast.cpp"
_JPEG_SRC = _DIR / "jpeg.cpp"
_J2K_SRC = _DIR / "jpeg2000.cpp"
_H5F_SRC = _DIR / "hdf5filters.cpp"
_ZSTD_SRC = _DIR / "zstd.cpp"
_JXR_SRC = _DIR / "jpegxr.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC"]
# the 9/7 wavelet must round as OpenJPEG does: no fused multiply-adds
# (GCC fuses them by default on aarch64), and integer lifting of corrupt
# streams wraps instead of being undefined
_EXTRA_FLAGS = {_J2K_SRC: ["-ffp-contract=off", "-fwrapv"],
                # the lapped transform of a corrupt stream wraps likewise
                _JXR_SRC: ["-fwrapv"]}

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()

D = ctypes.POINTER(ctypes.c_double)
L = ctypes.POINTER(ctypes.c_long)
I32 = ctypes.POINTER(ctypes.c_int32)
U8 = ctypes.POINTER(ctypes.c_ubyte)
P = ctypes.c_void_p

# name -> (restype, argtypes) of the entry points this package calls
_SIGNATURES = {
    "ring_simple": (ctypes.c_int, [D, ctypes.c_long]),
    "ring_metrics": (None, [D, ctypes.c_long, D]),
    "rings_batch": (None, [D, L, ctypes.c_long, D]),
    "points_in_ring": (None, [D, ctypes.c_long, D, ctypes.c_long, U8]),
    "dedup_keep": (ctypes.c_long, [D, D, ctypes.c_long, ctypes.c_double,
                                   U8]),
    "contours_batch": (ctypes.c_long, [I32, ctypes.c_long, ctypes.c_long,
                                       ctypes.c_long, I32, L, I32, L]),
    "contours_ccomp": (ctypes.c_long, [U8, ctypes.c_long, ctypes.c_long,
                                       ctypes.c_long, ctypes.c_long, I32, L,
                                       I32]),
}
_JPEG_SIGNATURES = {
    "jpeg_info": (ctypes.c_int, [P, ctypes.c_long, I32, P, ctypes.c_int]),
    "jpeg_decode": (ctypes.c_int, [P, ctypes.c_long, P, ctypes.c_long, P,
                                   ctypes.c_int]),
    "jpeg_encode": (ctypes.c_long, [P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, P, ctypes.c_long, P,
                                    ctypes.c_int]),
}
_J2K_SIGNATURES = {
    "j2k_info": (ctypes.c_int, [P, ctypes.c_long, I32, P, ctypes.c_int]),
    "j2k_decode": (ctypes.c_int, [P, ctypes.c_long, P, ctypes.c_long, P,
                                  ctypes.c_int]),
}

_H5F_SIGNATURES = {
    "h5_lzf_decode": (ctypes.c_long, [P, ctypes.c_long, P, ctypes.c_long]),
    "h5_szip_decode": (ctypes.c_long, [P, ctypes.c_long, P, ctypes.c_long,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, P,
                                       ctypes.c_int]),
}

_ZSTD_SIGNATURES = {
    "zstd_decompress": (ctypes.c_long, [P, ctypes.c_long, P, ctypes.c_long,
                                        ctypes.POINTER(P), P, ctypes.c_int]),
    "zstd_free": (None, [P]),
}

_JXR_SIGNATURES = {
    "jxr_info": (ctypes.c_int, [P, ctypes.c_long, I32, P, ctypes.c_int]),
    "jxr_decode": (ctypes.c_int, [P, ctypes.c_long, P, ctypes.c_long, P,
                                  ctypes.c_int]),
}


def _flags(src: Path) -> list[str]:
    return _FLAGS + _EXTRA_FLAGS.get(src, [])


def _target(src: Path = _SRC) -> Path:
    h = hashlib.sha1(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def _load(src: Path, signatures: dict) -> ctypes.CDLL:
    with _lock:
        if src in _libs:
            return _libs[src]
        out = _target(src)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cxx = os.environ.get("CXX", "g++")
            r = subprocess.run([cxx, *_flags(src), str(src), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {src.name} failed:\n"
                                   f"{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[src] = lib
        return lib


def load_geomfast() -> ctypes.CDLL:
    """The geometry core, built on first use; raises if it cannot be."""
    return _load(_SRC, _SIGNATURES)


def load_jpeg() -> ctypes.CDLL:
    """The JPEG codec, built on first use; raises if it cannot be."""
    return _load(_JPEG_SRC, _JPEG_SIGNATURES)


def load_jpeg2000() -> ctypes.CDLL:
    """The JPEG 2000 decoder, built on first use; raises if it cannot be."""
    return _load(_J2K_SRC, _J2K_SIGNATURES)


def load_hdf5filters() -> ctypes.CDLL:
    """The HDF5 lzf and szip filters, built on first use; raises if they
    cannot be."""
    return _load(_H5F_SRC, _H5F_SIGNATURES)


def load_zstd() -> ctypes.CDLL:
    """The zstd decoder, built on first use; raises if it cannot be."""
    return _load(_ZSTD_SRC, _ZSTD_SIGNATURES)


def load_jpegxr() -> ctypes.CDLL:
    """The JPEG XR decoder, built on first use; raises if it cannot be."""
    return _load(_JXR_SRC, _JXR_SIGNATURES)
