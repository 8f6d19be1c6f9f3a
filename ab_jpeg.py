"""A/B of the JPEG decoder (``classpose_tpu_torch/native/jpeg.cpp``)
against another copy of it, in one process on one host: both sources
built with the package's flags (``g++ -O2 -shared -fPIC``), every tile
of ``tests/golden/jpeg_region.svs`` (SOF2, SOF10, SOF9, 4:1:1) and that
region's level 0 re-encoded by the package's encoder (baseline 4:2:0 at
quality 80, the slide writer's tiles: SOF0) decoded by each in turns
(old, new, new, old) for ``--rounds`` rounds, on one thread and on the
WSI loader's reader threads; both must give the same pixels. Prints one
JSON object of MP/s medians and quartiles by process and side (also
written to ``--out``).

Usage (the old copy unpacked beside the repository first, e.g. ``git
archive <rev> classpose_tpu_torch/native | tar -x -C _archive/<rev>``):

    python3 ab_jpeg.py --old _archive/<rev> --rounds 5 --out ab_jpeg.json
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from classpose_tpu_torch.io import TiffSlide, jpeg  # noqa: E402
from classpose_tpu_torch.pipeline.slide_loader import SlideLoader  # noqa: E402

SVS = ROOT / "tests" / "golden" / "jpeg_region.svs"
TILE = 512


def build(src: Path, out: Path):
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src), "-o",
                    str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p, ctypes.c_int]
    return lib


def decoder(lib):
    def decode(data: bytes) -> np.ndarray:
        out = np.empty((TILE, TILE, 3), np.uint8)
        err = ctypes.create_string_buffer(256)
        if lib.jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                           err, 256):
            raise ValueError(err.value.decode())
        return out
    return decode


def tiles() -> dict[str, list[bytes]]:
    """Level 0's tiles by process (``jpeg_golden.json``), and the region
    re-encoded by the package's encoder."""
    spec = json.loads((SVS.parent / "jpeg_golden.json").read_text())["svs"]
    slide = TiffSlide(str(SVS))
    raw = SVS.read_bytes()
    page = slide._levels[0]
    by = {p: [] for p in spec["processes"]}
    for (o, n), w in zip(zip(page.offsets, page.counts), spec["levels"][0]):
        by[w["process"]].append(raw[o:o + n])
    side = spec["region"]
    region = slide.read_region((0, 0), 0, (side, side))
    slide.close()
    by["SOF0"] = [jpeg.encode(region[y:y + TILE, x:x + TILE, :3], 80)
                  for y in range(0, side, TILE)
                  for x in range(0, side, TILE)]
    return by


def rate(decode, streams, threads: int) -> float:
    t0 = time.perf_counter()
    if threads == 1:
        for s in streams:
            decode(s)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(decode, streams))
    return len(streams) * TILE * TILE / 1e6 / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="a directory holding classpose_tpu_torch/native/"
                    "jpeg.cpp")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=4,
                    help="times each tile is decoded in one timing")
    ap.add_argument("--out")
    args = ap.parse_args()
    src = {"old": Path(args.old) / "classpose_tpu_torch/native/jpeg.cpp",
           "new": ROOT / "classpose_tpu_torch/native/jpeg.cpp"}
    with tempfile.TemporaryDirectory() as tmp:
        dec = {k: decoder(build(p, Path(tmp) / f"{k}.so"))
               for k, p in src.items()}
        by = tiles()
        for name, streams in by.items():
            for s in streams:
                if not np.array_equal(dec["old"](s), dec["new"](s)):
                    raise AssertionError(f"{name}: old and new differ")
        threads = SlideLoader.n_read_threads
        runs = {k: {n: {1: [], threads: []} for n in by} for k in dec}
        for _ in range(args.rounds):
            for side in ("old", "new", "new", "old"):
                for name, streams in by.items():
                    for t in (1, threads):
                        runs[side][name][t].append(
                            rate(dec[side], streams * args.repeats, t))

    def summary(v):
        q = statistics.quantiles(v, n=4)
        return dict(median=statistics.median(v), q1=q[0], q3=q[2])

    result = {"old": str(args.old), "rounds": args.rounds,
              "threads": threads, "tiles": {n: len(s) for n, s in by.items()},
              "mp_per_s": {side: {name: {f"{t}t": summary(v)
                                         for t, v in per.items()}
                                  for name, per in sides.items()}
                           for side, sides in runs.items()}}
    text = json.dumps(result)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
