"""Minimal Zarr-v2 directory-store writer, no zarr dependency
(counterpart of ``classpose_tpu/io/zarrlite.py``).

Supports what the SpatialData export needs: groups with attributes,
C-order numpy arrays with zlib-compressed chunks, and variable-length
UTF-8 string arrays using the standard numcodecs ``vlen-utf8`` filter, so
a stock zarr/numcodecs (and hence anndata/spatialdata) installation opens
every array in the store.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

_DTYPE_MAP = {
    "float64": "<f8", "float32": "<f4", "int64": "<i8", "int32": "<i4",
    "uint8": "|u1", "int8": "|i1", "bool": "|b1", "uint32": "<u4",
    "uint64": "<u8", "float16": "<f2", "int16": "<i2", "uint16": "<u2",
}


def _vlen_utf8_encode(strings: list[str]) -> bytes:
    """numcodecs VLenUTF8 chunk encoding: LE uint32 item count, then per
    item LE uint32 byte length + utf-8 payload."""
    parts = [struct.pack("<I", len(strings))]
    for s in strings:
        b = s.encode("utf-8")
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def _vlen_utf8_decode(buf: bytes) -> list[str]:
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        out.append(buf[off : off + ln].decode("utf-8"))
        off += ln
    return out


class ZarrGroup:
    def __init__(self, path: str | Path, attrs: dict | None = None):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        (self.path / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
        if attrs:
            self.set_attrs(attrs)

    def set_attrs(self, attrs: dict) -> None:
        (self.path / ".zattrs").write_text(json.dumps(attrs, default=str))

    def group(self, name: str, attrs: dict | None = None) -> "ZarrGroup":
        return ZarrGroup(self.path / name, attrs)

    def string_array(
        self,
        name: str,
        strings: list[str],
        attrs: dict | None = None,
    ) -> None:
        """1-D variable-length string array (zarr v2 object dtype with the
        numcodecs ``vlen-utf8`` filter — the encoding anndata/zarr use for
        string columns). Single chunk (string columns here are small)."""
        strings = [str(s) for s in strings]
        adir = self.path / name
        adir.mkdir(parents=True, exist_ok=True)
        meta = {
            "zarr_format": 2,
            "shape": [len(strings)],
            "chunks": [max(len(strings), 1)],
            "dtype": "|O",
            "compressor": {"id": "zlib", "level": 4},
            "fill_value": None,
            "order": "C",
            "filters": [{"id": "vlen-utf8"}],
        }
        (adir / ".zarray").write_text(json.dumps(meta))
        if attrs:
            (adir / ".zattrs").write_text(json.dumps(attrs, default=str))
        (adir / "0").write_bytes(
            zlib.compress(_vlen_utf8_encode(strings), 4)
        )

    def array(
        self,
        name: str,
        data: np.ndarray,
        chunks: tuple[int, ...] | None = None,
        attrs: dict | None = None,
    ) -> None:
        data = np.ascontiguousarray(data)
        if data.dtype.kind in ("U", "S", "O"):
            # string data → standard vlen-utf8 encoding
            self.string_array(
                name, [str(x) for x in data.ravel().tolist()], attrs
            )
            return
        if chunks is None:
            chunks = tuple(min(s, 1_048_576 if data.ndim == 1 else 4096)
                           for s in data.shape)
        adir = self.path / name
        adir.mkdir(parents=True, exist_ok=True)
        dtype_str = _DTYPE_MAP.get(str(data.dtype))
        if dtype_str is None:
            raise TypeError(f"unsupported dtype {data.dtype}")
        meta = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": dtype_str,
            "compressor": {"id": "zlib", "level": 4},
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        (adir / ".zarray").write_text(json.dumps(meta))
        if attrs:
            (adir / ".zattrs").write_text(json.dumps(attrs, default=str))
        grid = [
            range(0, s, c) for s, c in zip(data.shape, chunks)
        ] or [range(1)]
        import itertools

        for starts in itertools.product(*grid):
            if data.ndim == 0:
                chunk = data
                key = "0"
            else:
                sl = tuple(
                    slice(st, min(st + c, s))
                    for st, c, s in zip(starts, chunks, data.shape)
                )
                chunk = data[sl]
                # pad partial edge chunks to full chunk shape (zarr spec)
                if chunk.shape != tuple(chunks):
                    full = np.zeros(chunks, data.dtype)
                    full[tuple(slice(0, e) for e in chunk.shape)] = chunk
                    chunk = full
                key = ".".join(
                    str(st // c) for st, c in zip(starts, chunks)
                )
            (adir / key).write_bytes(
                zlib.compress(np.ascontiguousarray(chunk).tobytes(), 4)
            )


def read_zarr_array(path: str | Path) -> np.ndarray:
    """Tiny reader for round-trip tests (numeric + vlen-utf8 arrays)."""
    path = Path(path)
    meta = json.loads((path / ".zarray").read_text())
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if meta.get("filters") and any(
        f.get("id") == "vlen-utf8" for f in meta["filters"]
    ):
        strings: list[str] = []
        for i in range(-(-shape[0] // chunks[0]) if shape[0] else 0):
            f = path / str(i)
            if f.exists():
                strings.extend(
                    _vlen_utf8_decode(zlib.decompress(f.read_bytes()))
                )
        return np.asarray(strings[: shape[0]], dtype=object)
    dtype = np.dtype(meta["dtype"])
    out = np.zeros(shape, dtype)
    import itertools

    grid = [range(0, s, c) for s, c in zip(shape, chunks)] or [range(1)]
    for starts in itertools.product(*grid):
        key = ".".join(str(st // c) for st, c in zip(starts, chunks)) or "0"
        f = path / key
        if not f.exists():
            continue
        chunk = np.frombuffer(
            zlib.decompress(f.read_bytes()), dtype
        ).reshape(chunks)
        sl = tuple(
            slice(st, min(st + c, s))
            for st, c, s in zip(starts, chunks, shape)
        )
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out
