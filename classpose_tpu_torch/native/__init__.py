"""The native geometry core (``geomfast.cpp``), built on first use.

:func:`load_geomfast` compiles the source with ``g++`` into
``classpose_tpu_torch/_build/`` (the kernels' build directory, which git
ignores), named by a hash of the source and the flags, and loads it with
``ctypes``. Nothing happens at import. A build or load failure raises:
the package has no slower fallback for contours, metrics, containment or
deduplication.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "geomfast.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC"]

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

D = ctypes.POINTER(ctypes.c_double)
L = ctypes.POINTER(ctypes.c_long)
I32 = ctypes.POINTER(ctypes.c_int32)
U8 = ctypes.POINTER(ctypes.c_ubyte)

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
}


def _target() -> Path:
    h = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libgeomfast_{h.hexdigest()[:12]}.so"


def load_geomfast() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cxx = os.environ.get("CXX", "g++")
            r = subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building geomfast.cpp failed:\n"
                                   f"{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib
