"""HDF5 reader and writer of the package's own, in numpy, ``zlib`` and
``struct``, for the files the training data path uses: the layout that
h5py writes at its default settings (HDF5's "earliest" format) and the
JAX package's ``dataset_to_hdf5`` produces.

That layout is:

- superblock version 0 (offsets and lengths of 8 bytes);
- version 1 object headers, whose messages may go on in continuation
  blocks;
- groups as symbol tables: a local heap of names, a version 1 B-tree of
  group nodes, and symbol table nodes (``SNOD``);
- datasets with a dataspace, a datatype (little-endian IEEE float of 4
  or 8 bytes, signed or unsigned integer of 1 to 8 bytes), a fill value,
  a version 3 layout (compact, contiguous or chunked) and, when chunked,
  an optional filter pipeline of deflate only;
- the chunks of a chunked dataset indexed by a version 1 B-tree of any
  depth (a superblock of version 0 fixes its K at 32, so a node holds at
  most 64 chunks); edge chunks are stored whole and cut on reading.

:class:`File` opens such a file as a read-only mapping of dataset names
(at any depth of groups, joined by ``/``) to :class:`Dataset`; a dataset
reads ``ds[i]``, ``ds[a:b]`` (axis 0) and ``np.asarray(ds)``. Anything
else raises a ``ValueError`` that names it: superblock versions 2 and 3
(``libver="latest"``), version 2 object headers, link messages and dense
link storage, shared messages, filters other than deflate (shuffle,
fletcher32, szip, ...), big-endian, compound, string, variable-length and
other datatypes, scalar and null dataspaces, layout versions other than
3, external and virtual storage.

:class:`Writer` writes the same layout: ``create_dataset`` with h5py's
arguments (``chunks``, ``compression="gzip"``, ``compression_opts``),
contiguous when unchunked, chunked with a B-tree of as many levels as
the chunk count needs. h5py reads what it writes, bit for bit.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
CHUNK_K = 32        # chunk B-tree K under a version 0 superblock
GROUP_K = 16        # group B-tree K (h5py's default)
LEAF_K = 4          # symbol table node K (h5py's default)

# object header message types read or written (others are skipped)
DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, EXTERNAL = 1, 2, 3, 5, 6, 7
LAYOUT, FILTERS, CONTINUATION, SYMBOL_TABLE = 8, 11, 16, 17

FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset"}
CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
               6: "compound", 7: "reference", 8: "enum",
               9: "variable-length", 10: "array"}


class _Reader:
    """Little-endian fields at absolute offsets of an open file."""

    def __init__(self, fh):
        self.fh = fh

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        b = self.fh.read(n)
        if len(b) != n:
            raise ValueError(f"HDF5: truncated file ({n} bytes at {addr})")
        return b


def _u(b: bytes, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


def _messages(rd: _Reader, addr: int) -> list[tuple[int, int, bytes]]:
    """(type, flags, data) of every message of the version 1 object
    header at ``addr``, continuation blocks followed."""
    head = rd.read(addr, 16)
    if head[:4] == b"OHDR":
        raise ValueError("HDF5: version 2 object headers are not "
                         "supported (written under libver='latest' or "
                         "track_order=True)")
    if head[0] != 1:
        raise ValueError(f"HDF5: object header version {head[0]} is not "
                         f"supported")
    count = _u(head, 2, 2)
    blocks = [(addr + 16, _u(head, 8, 4))]
    out = []
    while blocks:
        start, size = blocks.pop(0)
        body = rd.read(start, size)
        pos = 0
        while pos + 8 <= size and len(out) < count:
            mtype, msize, flags = _u(body, pos, 2), _u(body, pos + 2, 2), \
                body[pos + 4]
            data = body[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if flags & 0x02:
                raise ValueError(f"HDF5: shared message (type {mtype}) is "
                                 f"not supported")
            if mtype == CONTINUATION:
                blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
            out.append((mtype, flags, data))
    return out


def _datatype(d: bytes) -> np.dtype:
    cls, bits, size = d[0] & 0x0F, _u(d, 1, 3), _u(d, 4, 4)
    if cls in (0, 1) and bits & 0x01:
        raise ValueError("HDF5: big-endian datatypes are not supported")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise ValueError(f"HDF5: integers of {size} bytes are not "
                             f"supported")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:
        if size not in (4, 8) or (bits >> 8) & 0xFF != size * 8 - 1:
            raise ValueError(f"HDF5: floating point of {size} bytes in a "
                             f"layout other than IEEE is not supported")
        return np.dtype(f"<f{size}")
    raise ValueError(f"HDF5: {CLASS_NAMES.get(cls, f'class {cls}')} "
                     f"datatypes are not supported")


def _dataspace(d: bytes) -> tuple[int, ...]:
    version, rank, flags = d[0], d[1], d[2]
    if version == 1:
        off = 8
    elif version == 2:
        off = 4
        if d[3] == 2:
            raise ValueError("HDF5: null dataspaces are not supported")
    else:
        raise ValueError(f"HDF5: dataspace message version {version} is "
                         f"not supported")
    if rank == 0:
        raise ValueError("HDF5: scalar datasets are not supported")
    return tuple(_u(d, off + 8 * i, 8) for i in range(rank))


def _filters(d: bytes) -> list[int]:
    """The filter ids of a pipeline message; deflate is the only one
    read."""
    version, n = d[0], d[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u(d, pos, 2)
        if version == 1 or fid >= 256:
            name_len = _u(d, pos + 2, 2)
            pos += 4
        else:
            name_len = 0
            pos += 2
        nvals = _u(d, pos + 2, 2)
        pos += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        pos += name_len + 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid != 1:
            what = (f"the {FILTER_NAMES[fid]} filter" if fid in FILTER_NAMES
                    else f"filter id {fid}")
            raise ValueError(f"HDF5: {what} is not supported (deflate "
                             f"only)")
        out.append(fid)
    return out


def _chunk_index(rd: _Reader, addr: int, ndims: int
                 ) -> dict[tuple[int, ...], tuple[int, int, int]]:
    """Chunk offset (in elements) → (address, stored bytes, filter mask)
    over the version 1 chunk B-tree at ``addr``, every level walked."""
    entry = np.dtype([("nbytes", "<u4"), ("mask", "<u4"),
                      ("offset", "<u8", (ndims,)), ("child", "<u8")])
    out = {}
    stack = [addr]
    while stack:
        node = stack.pop()
        head = rd.read(node, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"HDF5: no chunk B-tree node at {node}")
        level, used = head[5], _u(head, 6, 2)
        ents = np.frombuffer(rd.read(node + 24, used * entry.itemsize),
                             entry)
        if level:
            stack += ents["child"].tolist()[::-1]
            continue
        for off, child, nbytes, mask in zip(
                ents["offset"][:, :-1].tolist(), ents["child"].tolist(),
                ents["nbytes"].tolist(), ents["mask"].tolist()):
            out[tuple(off)] = (child, nbytes, mask)
    return out


class Dataset:
    """One dataset of an open :class:`File`: ``shape``, ``dtype``,
    ``chunks`` (None unless chunked), ``ds[i]``/``ds[a:b]`` on axis 0 and
    ``np.asarray(ds)``."""

    def __init__(self, rd: _Reader, name: str,
                 msgs: list[tuple[int, int, bytes]]):
        self._rd = rd
        self.name = name
        self.shape: tuple[int, ...] = ()
        self.dtype: np.dtype | None = None
        self.chunks: tuple[int, ...] | None = None
        self._filters: list[int] = []
        self._fill = None
        self._index = None
        layout = None
        for mtype, _, d in msgs:
            if mtype == DATASPACE:
                self.shape = _dataspace(d)
            elif mtype == DATATYPE:
                self.dtype = _datatype(d)
            elif mtype == FILL:
                self._fill = d
            elif mtype == LAYOUT:
                layout = d
            elif mtype == FILTERS:
                self._filters = _filters(d)
            elif mtype == EXTERNAL:
                raise ValueError("HDF5: external storage is not supported")
        if layout is None or self.dtype is None:
            raise ValueError(f"HDF5: {name} is not a dataset")
        if layout[0] != 3:
            raise ValueError(f"HDF5: layout message version {layout[0]} "
                             f"is not supported (version 3 only)")
        self._kind = layout[1]
        if self._kind == 0:
            size = _u(layout, 2, 2)
            self._compact = layout[4:4 + size]
        elif self._kind == 1:
            self._addr, self._size = _u(layout, 2, 8), _u(layout, 10, 8)
        elif self._kind == 2:
            ndims = layout[2]
            self._addr = _u(layout, 3, 8)
            dims = [_u(layout, 11 + 4 * i, 4) for i in range(ndims)]
            self.chunks = tuple(dims[:-1])
        else:
            raise ValueError("HDF5: virtual datasets are not supported")

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def compression(self) -> str | None:
        return "gzip" if self._filters else None

    def _fill_value(self):
        """The fill value where the message defines one, else 0."""
        d = self._fill
        if d is None or d[0] not in (2, 3):
            return 0
        if d[0] == 2:
            if not d[3]:
                return 0
            size, val = _u(d, 4, 4), d[8:]
        else:
            if not d[1] & 0x20:
                return 0
            size, val = _u(d, 2, 4), d[6:]
        if size == 0:
            return 0
        return np.frombuffer(val[:size], self.dtype)[0]

    def _rows(self, a: int, b: int) -> np.ndarray:
        """Rows a..b (axis 0) as a C-ordered array."""
        shape = (b - a,) + self.shape[1:]
        item = self.dtype.itemsize
        if self._kind == 0:
            full = np.frombuffer(self._compact, self.dtype).reshape(
                self.shape)
            return full[a:b].copy()
        if self._kind == 1:
            if self._addr == UNDEF:
                return np.full(shape, self._fill_value(), self.dtype)
            row = int(np.prod(self.shape[1:], dtype=np.int64)) * item
            raw = self._rd.read(self._addr + a * row, (b - a) * row)
            return np.frombuffer(raw, self.dtype).reshape(shape).copy()
        out = np.full(shape, self._fill_value(), self.dtype)
        if self._index is None:
            self._index = ({} if self._addr == UNDEF else _chunk_index(
                self._rd, self._addr, len(self.chunks) + 1))
        c = self.chunks
        grid = [range(0, n, k) for n, k in zip(self.shape[1:], c[1:])]
        for r0 in range(a // c[0] * c[0], b, c[0]):
            for rest in np.ndindex(*[len(g) for g in grid]):
                origin = (r0,) + tuple(g[i] for g, i in zip(grid, rest))
                entry = self._index.get(origin)
                if entry is None:
                    continue
                block = self._chunk(*entry)
                src = tuple(slice(max(a - r0, 0) if d == 0 else 0,
                                  min(b - r0, c[0]) if d == 0
                                  else min(c[d], self.shape[d] - o))
                            for d, o in enumerate(origin))
                dst = tuple(slice(max(r0, a) - a, min(r0 + c[0], b) - a)
                            if d == 0 else slice(o, o + s.stop)
                            for d, (o, s) in enumerate(zip(origin, src)))
                out[dst] = block[src]
        return out

    def _chunk(self, addr: int, nbytes: int, mask: int) -> np.ndarray:
        raw = self._rd.read(addr, nbytes)
        for i in reversed(range(len(self._filters))):
            if not mask & (1 << i):
                raw = zlib.decompress(raw)
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            if len(key) != 1:
                raise IndexError("only axis 0 is indexed")
            key = key[0]
        if key is Ellipsis:
            key = slice(None)
        if isinstance(key, slice):
            a, b, step = key.indices(self.shape[0])
            if step != 1:
                raise IndexError("slices on axis 0 take no step")
            return self._rows(a, max(a, b))
        i = int(key)
        if i < 0:
            i += self.shape[0]
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"index {key} out of range for "
                             f"{self.shape[0]} rows")
        return self._rows(i, i + 1)[0]

    def __array__(self, dtype=None, copy=None):
        out = self._rows(0, self.shape[0])
        return out if dtype is None else out.astype(dtype)


class File:
    """A read-only HDF5 file of the layout in the module docstring: a
    mapping of dataset name → :class:`Dataset`."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        try:
            self._rd = _Reader(self._fh)
            self._datasets: dict[str, Dataset] = {}
            root = self._superblock()
            self._group(root, "")
        except BaseException:
            self._fh.close()
            raise

    def _superblock(self) -> int:
        b = self._rd.read(0, 8 + 16)
        if b[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (at offset 0)")
        version = b[8]
        if version not in (0, 1):
            raise ValueError(f"HDF5: superblock version {version} is not "
                             f"supported (versions 2/3 come from "
                             f"libver='latest'; version 0 or 1 only)")
        if b[13] != 8 or b[14] != 8:
            raise ValueError("HDF5: offsets and lengths of other than 8 "
                             "bytes are not supported")
        start = 24 + (4 if version == 1 else 0)
        sb = self._rd.read(start, 32 + 40)
        if _u(sb, 0, 8) != 0:
            raise ValueError("HDF5: a base address other than 0 is not "
                             "supported")
        return _u(sb, 32 + 8, 8)     # root entry's object header

    def _group(self, addr: int, prefix: str) -> None:
        msgs = _messages(self._rd, addr)
        types = {m[0] for m in msgs}
        if LINK_INFO in types or LINK in types:
            raise ValueError("HDF5: link messages and dense link storage "
                             "(new-style groups) are not supported; "
                             "symbol-table groups only")
        stab = [d for t, _, d in msgs if t == SYMBOL_TABLE]
        if not stab:
            self._datasets[prefix.rstrip("/")] = Dataset(
                self._rd, prefix.rstrip("/"), msgs)
            return
        btree, heap = _u(stab[0], 0, 8), _u(stab[0], 8, 8)
        h = self._rd.read(heap, 32)
        if h[:4] != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {heap}")
        names = self._rd.read(_u(h, 24, 8), _u(h, 8, 8))
        for name_off, obj in self._symbols(btree):
            name = names[name_off:names.index(b"\0", name_off)].decode()
            self._group(obj, f"{prefix}{name}/")

    def _symbols(self, addr: int) -> list[tuple[int, int]]:
        """(name offset in the heap, object header address) of every
        entry under the group B-tree node at ``addr``."""
        head = self._rd.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"HDF5: no group B-tree node at {addr}")
        level, used = head[5], _u(head, 6, 2)
        body = self._rd.read(addr + 24, used * 16 + 8)
        out = []
        for i in range(used):
            child = _u(body, i * 16 + 8, 8)
            if level:
                out += self._symbols(child)
                continue
            snod = self._rd.read(child, 8)
            if snod[:4] != b"SNOD":
                raise ValueError(f"HDF5: no symbol table node at {child}")
            n = _u(snod, 6, 2)
            ents = self._rd.read(child + 8, 40 * n)
            out += [(_u(ents, 40 * j, 8), _u(ents, 40 * j + 8, 8))
                    for j in range(n)]
        return out

    def __getitem__(self, name: str) -> Dataset:
        return self._datasets[name.strip("/")]

    def __contains__(self, name) -> bool:
        return str(name).strip("/") in self._datasets

    def __iter__(self):
        return iter(self._datasets)

    def __len__(self) -> int:
        return len(self._datasets)

    def keys(self):
        return self._datasets.keys()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dtype_message(dt: np.dtype) -> bytes:
    if dt.kind == "f" and dt.itemsize in (4, 8):
        bits = dt.itemsize * 8
        exp_loc, exp_size, mant, bias = ((23, 8, 23, 127) if bits == 32
                                         else (52, 11, 52, 1023))
        return struct.pack("<B3BI HHBBBBI", 0x11, 0x20, bits - 1, 0,
                           dt.itemsize, 0, bits, exp_loc, exp_size, 0, mant,
                           bias)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return struct.pack("<B3BIHH", 0x10, 0x08 if dt.kind == "i" else 0,
                           0, 0, dt.itemsize, 0, dt.itemsize * 8)
    raise ValueError(f"hdf5.Writer: dtype {dt} is not supported (floats of "
                     f"4 or 8 bytes and integers)")


class Writer:
    """Writes the layout of the module docstring; use as a context
    manager, then ``create_dataset`` as with h5py. Data goes to the file
    as each dataset is created; the headers, the B-trees, the group and
    the superblock go at ``close``."""

    def __init__(self, path):
        self.path = str(path)
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "wb")
        self._fh.write(b"\0" * 96)           # the superblock, at close
        self._datasets: dict[str, list[bytes]] = {}

    def _append(self, data: bytes) -> int:
        addr = self._fh.tell()
        self._fh.write(data)
        return addr

    def create_dataset(self, name: str, data, chunks=None,
                       compression: str | None = None,
                       compression_opts: int | None = None) -> None:
        if "/" in name.strip("/") or name in self._datasets:
            raise ValueError(f"hdf5.Writer: {name!r}: one new name at the "
                             f"root only")
        arr = np.ascontiguousarray(data)
        dt = arr.dtype.newbyteorder("<")
        arr = arr.astype(dt, copy=False)
        dtype_msg = _dtype_message(dt)
        dims = b"".join(struct.pack("<Q", n) for n in arr.shape)
        space = struct.pack("<BBB5x", 1, arr.ndim, 1) + dims + dims
        msgs = [_message(DATASPACE, space), _message(DATATYPE, dtype_msg, 1)]
        if compression not in (None, "gzip"):
            raise ValueError(f"hdf5.Writer: compression {compression!r} is "
                             f"not supported (gzip only)")
        if compression and chunks is None:
            chunks = arr.shape
        if chunks is None:
            addr = self._append(arr.tobytes()) if arr.size else UNDEF
            msgs.append(_message(FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), 1))
            msgs.append(_message(LAYOUT, struct.pack(
                "<BBQQ", 3, 1, addr, arr.nbytes)))
        else:
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != arr.ndim or min(chunks) < 1:
                raise ValueError(f"hdf5.Writer: chunks {chunks} do not fit "
                                 f"shape {arr.shape}")
            level = (None if compression is None
                     else 4 if compression_opts is None
                     else int(compression_opts))
            btree = self._chunks(arr, chunks, level)
            msgs.append(_message(FILL, bytes([2, 3, 2, 1, 0, 0, 0, 0]), 1))
            if level is not None:
                msgs.append(_message(FILTERS, struct.pack(
                    "<BB6xHHHH8sI4x", 1, 1, 1, 8, 1, 1, b"deflate", level),
                    1))
            msgs.append(_message(LAYOUT, struct.pack(
                f"<BBBQ{len(chunks) + 1}I", 3, 2, len(chunks) + 1, btree,
                *chunks, dt.itemsize)))
        self._datasets[name.strip("/")] = msgs

    def _chunks(self, arr: np.ndarray, chunks: tuple[int, ...],
                level: int | None) -> int:
        """Writes every chunk (edge chunks whole, zero-padded) and the
        chunk B-tree over them; returns the root node's address."""
        grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
        entries = []
        for origin in np.ndindex(*[len(g) for g in grid]):
            off = tuple(g[i] for g, i in zip(grid, origin))
            block = arr[tuple(slice(o, o + c) for o, c in zip(off, chunks))]
            if block.shape != chunks:
                full = np.zeros(chunks, arr.dtype)
                full[tuple(slice(0, s) for s in block.shape)] = block
                block = full
            raw = np.ascontiguousarray(block).tobytes()
            if level is not None:
                raw = zlib.compress(raw, level)
            entries.append((off + (0,), len(raw), self._append(raw)))
        if not entries:
            return UNDEF
        last = entries[-1][0]
        end = tuple(o + c for o, c in zip(last, chunks + (arr.itemsize,)))
        # leaves: (first key, last key, child address) of each chunk
        level_items = [(off, off, addr, nbytes)
                       for off, nbytes, addr in entries]
        depth = 0
        while True:
            groups = [level_items[i:i + 2 * CHUNK_K]
                      for i in range(0, len(level_items), 2 * CHUNK_K)]
            keys_after = [g[0][0] for g in groups[1:]] + [end]
            key_size = 8 + 8 * len(end)
            node_size = 24 + (2 * CHUNK_K + 1) * key_size \
                + 2 * CHUNK_K * 8
            base = self._fh.tell()
            addrs = [base + i * node_size for i in range(len(groups))]
            for i, g in enumerate(groups):
                left = addrs[i - 1] if i else UNDEF
                right = addrs[i + 1] if i + 1 < len(groups) else UNDEF
                body = b""
                for first, _, child, nbytes in g:
                    body += struct.pack(f"<II{len(first)}QQ", nbytes, 0,
                                        *first, child)
                body += struct.pack(f"<II{len(end)}Q", 0, 0,
                                    *keys_after[i])
                node = b"TREE" + struct.pack("<BBHQQ", 1, depth, len(g),
                                             left, right) + body
                self._append(node + b"\0" * (node_size - len(node)))
            if len(groups) == 1:
                return addrs[0]
            level_items = [(g[0][0], None, a, 0)
                           for g, a in zip(groups, addrs)]
            depth += 1

    def close(self) -> None:
        if self._fh.closed:
            return
        names = sorted(self._datasets, key=lambda s: s.encode())
        headers = {n: self._append(_object_header(self._datasets[n]))
                   for n in names}
        # local heap of names: "" at 0, then each name, 8-byte aligned
        heap_data, offsets = b"\0" * 8, {}
        for n in names:
            offsets[n] = len(heap_data)
            heap_data += _pad8(n.encode() + b"\0")
        heap = self._fh.tell()
        self._append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                           heap + 32) + heap_data)
        # symbol table nodes of up to 2·LEAF_K entries, under one B-tree
        # node of up to 2·GROUP_K children
        per = 2 * LEAF_K
        snods = [names[i:i + per] for i in range(0, len(names), per)] or [[]]
        if len(snods) > 2 * GROUP_K:
            raise ValueError(f"hdf5.Writer: more than "
                             f"{2 * GROUP_K * per} datasets")
        snod_size = 8 + per * 40
        snod_addrs = []
        for group in snods:
            body = b"".join(struct.pack("<QQI4x16x", offsets[n], headers[n],
                                        0) for n in group)
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(group)) + body
            snod_addrs.append(self._append(
                node + b"\0" * (snod_size - len(node))))
        body = struct.pack("<Q", 0)
        for group, addr in zip(snods, snod_addrs):
            body += struct.pack("<QQ", addr,
                                offsets[group[-1]] if group else 0)
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF,
                                     UNDEF) + body
        btree_size = 24 + (2 * GROUP_K + 1) * 8 + 2 * GROUP_K * 8
        btree = self._append(node + b"\0" * (btree_size - len(node)))
        root = self._append(_object_header(
            [_message(SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
        eof = self._fh.tell()
        self._fh.seek(0)
        self._fh.write(SIGNATURE + struct.pack(
            "<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, GROUP_K, 0)
            + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
            + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
        self._fh.close()

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
