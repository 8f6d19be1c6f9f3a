"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` (with the shared ``csrc/*.cuh`` headers, which are part of the
cache key) into its own shared library under ``classpose_tpu_torch/_build/``
on first use (one ``nvcc`` per source, all started together), then loaded
with ``ctypes``. Every pointer and the CUDA stream cross the boundary as
``c_void_p``; each C entry point returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0.

Every launch goes through :func:`call`, which makes the tensors' card the
calling thread's current CUDA device first: the C side launches on the
current device, and sets its shared-memory limits and sizes its
persistent grids for that device, so a thread whose current device is
another card would pass a stream of the wrong card.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.

``LAUNCHES`` holds one plain integer per kernel. A wrapper adds one per
launch (:func:`count`, under a lock: the WSI pipeline launches from two
inference threads) where it launches its kernel and nowhere else, so a
caller can reset the counts, drive a path, and read which kernels it went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

# per-source extra flags: the sampler and the diffusion must match their
# plain versions bitwise, so no multiply-add contraction there
SOURCES = {
    "attention": [],
    "attention_bwd": [],
    "sample": ["-fmad=false"],
    "diffusion": ["-fmad=false"],
    "attention_hm": [],
    "layernorm": [],
}

# kernel name -> launch count (see module docstring)
LAUNCHES = {
    "attention_fwd": 0,
    "attention_bwd": 0,
    "bilinear_sample": 0,
    "landing_histogram": 0,
    "masked_diffusion": 0,
    "layernorm": 0,
    "diffuse_blocked": 0,
    "flash_attention_relpos": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int

# C signatures: name -> (library, argtypes)
_SIGNATURES = {
    "attn_fwd_bf16": ("attention",
                      [P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]),
    "attn_bwd_bf16": ("attention_bwd",
                      [P, P, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float,
                       P]),
    "bilinear_sample_f32": ("sample", [P, P, P, P, I, I, I, I, P]),
    "landing_histogram_f32": ("sample", [P, P, P, P, I, I, I, P]),
    "diffusion_pack_nbr": ("diffusion", [P, P, P, P, I, I, I, P]),
    "diffusion_rounds": ("diffusion",
                         [P, P, P, P, P, P, I, I, I, I, I, I, P, P]),
    "layernorm_bf16": ("layernorm", [P, P, P, P, I, I, ctypes.c_float, I, P]),
    "attn_hm_f32": ("attention_hm",
                    [P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]),
    "attn_hm_bf16": ("attention_hm",
                     [P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float, P]),
}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches (default one) of kernel ``name``."""
    with _count_lock:
        LAUNCHES[name] += n


def _nvcc() -> str:
    return os.environ.get("NVCC", NVCC_DEFAULT)


def _cmd(name: str, out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", *SOURCES[name],
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(_cmd(name, Path("x"))[1:-3]).encode()
    h = hashlib.sha1(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library in parallel; return seconds per
    source compiled in this call (0.0 for a cached one)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (
            subprocess.Popen(
                _cmd(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            out = _target(name)
            if not out.exists():
                build_all([name])
            cdll = ctypes.CDLL(str(out))
            for fn, (owner, argtypes) in _SIGNATURES.items():
                if owner == name:
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")


def call(library, fn: str, device, *args, tail=()) -> None:
    """Launch C entry point ``fn`` of ``library`` (a name in
    :data:`SOURCES`, or a loaded ``CDLL`` such as an A/B build) for
    tensors on CUDA ``device``: ``args``, then the current stream of
    ``device``, then ``tail``, with ``device`` the calling thread's
    current device for the call; raises when ``fn`` returns an error."""
    import torch

    cdll = lib(library) if isinstance(library, str) else library
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(getattr(cdll, fn)(*args, stream, *tail), fn)
