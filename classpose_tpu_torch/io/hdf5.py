"""HDF5 reader and writer of the package's own, in numpy, ``zlib`` and
``struct`` (with two filters in C++, ``native/hdf5filters.cpp``), for the
files the training data path uses: whatever h5py writes for a numeric
training set, at its defaults and past them, and the JAX package's
``dataset_to_hdf5`` output.

The reader takes:

- superblock versions 0 to 3 (offsets and lengths of 8 bytes; the
  lookup3 checksum of versions 2 and 3 checked);
- object headers of version 1 and 2 (``OHDR``, continuation blocks
  ``OCHK``, checksums, creation order), attributes skipped unread;
  shared messages: committed datatypes, and the dataspace, datatype, fill
  value and filter pipeline messages of a file with a shared message
  table (superblock extension, ``SMTB``; each index's messages in a
  fractal heap, the index a list or a version 2 B-tree);
- old-style groups (a local heap of names, a version 1 B-tree of group
  nodes, ``SNOD`` nodes; soft links in entries of cache type 2) and
  new-style ones: link messages (hard and soft links; external links
  followed when their name is read, the target file found as HDF5 finds
  it and read by this reader, chains of them up to HDF5's limit of 16
  links), and dense link storage (a fractal heap of link messages,
  ``FRHP``/``FHDB``/``FHIB``, indexed by a version 2 B-tree,
  ``BTHD``/``BTIN``/``BTLF``); soft links resolved as HDF5 follows them,
  to datasets and to groups, in chains, dangling ones listed;
- dataspaces simple and scalar; datatypes little- and big-endian IEEE
  floats of 2, 4 and 8 bytes, integers of 1 to 8 bytes, either at a
  precision below its size (at an offset; floats with other fields),
  converted to the dtype h5py reads them as, h5py's bool enum (read as
  ``bool``) and other integer enums (read as their base type), committed
  (named) datatypes;
- layouts of version 3 and 4: compact, contiguous, external storage
  (names resolved as HDF5 resolves them: relative to the working
  directory), virtual (sources in the same file or another, "all" and
  regular hyperslab selections, the fill value where nothing maps), and
  chunked with any index: a version 1 B-tree of any depth, single chunk,
  implicit, fixed array (paged or not), extensible array and version 2
  B-tree; edge chunks are stored whole and cut on reading;
- filters, in pipeline order and per each chunk's filter mask: deflate,
  shuffle, fletcher32 (checked), lzf, szip, scaleoffset (integer and
  float D-scale) and nbit (at full precision its bytes pass through).

:class:`File` opens such a file as a read-only mapping of dataset names
(at any depth of groups, joined by ``/``; a soft link is a name of its
target) to :class:`Dataset`; a dataset reads ``ds[i]``, ``ds[a:b]``
(axis 0), ``ds[()]`` and ``np.asarray(ds)`` as h5py does, byte order
included; a dangling soft link is listed and reads as missing
(``KeyError``; ``get`` gives the default), as in h5py. Anything else
raises a ``ValueError`` that names it: layout versions 1 and 2, null
dataspaces, floats wider than float64 or of sizes other than 2, 4 and 8
bytes, and string, compound, variable-length, reference, array, opaque,
bitfield and time datatypes (under nbit too); so does an external link
whose file or object is missing, or a cycle of soft links, when its name
is read (a file that never reads it opens).

:class:`Writer` writes h5py's default layout: ``create_dataset`` with
h5py's arguments (``chunks``, ``compression="gzip"``,
``compression_opts``), contiguous when unchunked, chunked with a B-tree of
as many levels as the chunk count needs. h5py reads what it writes, bit
for bit.
"""

from __future__ import annotations

import ctypes
import os
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
LAYOUT, FILTERS, SHARED_TABLE, CONTINUATION, SYMBOL_TABLE = 8, 11, 15, 16, 17

DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET, LZF = \
    1, 2, 3, 4, 5, 6, 32000
FILTER_NAMES = {DEFLATE: "deflate", SHUFFLE: "shuffle",
                FLETCHER32: "fletcher32", SZIP: "szip", NBIT: "nbit",
                SCALEOFFSET: "scaleoffset", LZF: "lzf"}
NUM_LINKS = 16      # HDF5's limit on links followed in one lookup
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


def _lookup3(data: bytes) -> int:
    """Jenkins' lookup3 ``hashlittle`` with seed 0, HDF5's metadata
    checksum."""
    m = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & m

    n = len(data)
    a = b = c = (0xDEADBEEF + n) & m
    i = 0
    while n > 12:
        a = (a + _u(data, i, 4)) & m
        b = (b + _u(data, i + 4, 4)) & m
        c = (c + _u(data, i + 8, 4)) & m
        a = ((a - c) & m) ^ rot(c, 4)
        c = (c + b) & m
        b = ((b - a) & m) ^ rot(a, 6)
        a = (a + c) & m
        c = ((c - b) & m) ^ rot(b, 8)
        b = (b + a) & m
        a = ((a - c) & m) ^ rot(c, 16)
        c = (c + b) & m
        b = ((b - a) & m) ^ rot(a, 19)
        a = (a + c) & m
        c = ((c - b) & m) ^ rot(b, 4)
        b = (b + a) & m
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = data[i:] + bytes(12 - n)
    a = (a + _u(tail, 0, 4)) & m
    b = (b + _u(tail, 4, 4)) & m
    c = (c + _u(tail, 8, 4)) & m
    c = ((c ^ b) - rot(b, 14)) & m
    a = ((a ^ c) - rot(c, 11)) & m
    b = ((b ^ a) - rot(a, 25)) & m
    c = ((c ^ b) - rot(b, 16)) & m
    a = ((a ^ c) - rot(c, 4)) & m
    b = ((b ^ a) - rot(a, 14)) & m
    c = ((c ^ b) - rot(b, 24)) & m
    return c


def _checked(block: bytes, what: str) -> bytes:
    if _lookup3(block[:-4]) != _u(block, len(block) - 4, 4):
        raise ValueError(f"HDF5: {what}: checksum mismatch")
    return block


def _signed(rd: _Reader, addr: int, n: int, sig: bytes) -> bytes:
    b = rd.read(addr, n)
    if b[:4] != sig:
        raise ValueError(f"HDF5: no {sig.decode()} at {addr}")
    return b


def _enc_size(n: int) -> int:
    """Bytes that encode n (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _messages(rd: _Reader, addr: int) -> list[tuple[int, int, bytes]]:
    """(type, flags, data) of every message of the object header at
    ``addr`` (version 1, or 2 with its ``OCHK`` blocks), continuation
    blocks followed."""
    head = rd.read(addr, 16)
    if head[:4] == b"OHDR":
        return _messages_v2(rd, addr)
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
            if mtype == CONTINUATION:
                blocks.append((_u(data, 0, 8), _u(data, 8, 8)))
            out.append((mtype, flags, data))
    return out


def _messages_v2(rd: _Reader, addr: int) -> list[tuple[int, int, bytes]]:
    pre = rd.read(addr, 6)
    if pre[4] != 2:
        raise ValueError(f"HDF5: object header version {pre[4]} is not "
                         f"supported")
    flags = pre[5]
    pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    size = _u(rd.read(addr + pos, width), 0, width)
    pos += width
    head = _checked(rd.read(addr, pos + size + 4), "object header")
    hdr = 6 if flags & 0x04 else 4     # type, size, flags, creation order
    blocks = [(head, pos, pos + size)]
    out = []
    while blocks:
        body, p, end = blocks.pop(0)
        while p + hdr <= end:
            mtype, msize, mflags = body[p], _u(body, p + 1, 2), body[p + 3]
            data = body[p + hdr:p + hdr + msize]
            p += hdr + msize
            if mtype == CONTINUATION:
                caddr, clen = _u(data, 0, 8), _u(data, 8, 8)
                block = _checked(_signed(rd, caddr, clen, b"OCHK"),
                                 "object header continuation")
                blocks.append((block, 4, clen - 4))
            out.append((mtype, mflags, data))
    return out


def _shared(d: bytes) -> tuple[bool, object]:
    """Where a shared message's body is (H5O__shared_decode): (True, the
    fractal heap ID) in the file's shared message heap (version 3, type
    1), else (False, the address of the object header that holds it: a
    committed datatype's, or any message of versions 1 and 2)."""
    version, kind = d[0], d[1]
    if version == 1:
        return False, _u(d, 8, 8)
    if version not in (2, 3):
        raise ValueError(f"HDF5: shared message version {version} is not "
                         f"supported")
    if version == 3 and kind == 1:
        return True, d[2:10]
    return False, _u(d, 2, 8)


_IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127),
         8: (52, 11, 0, 52, 1023)}
_FLOATS = [(n, np.finfo(f"f{n}")) for n in (2, 4, 8)]


def _datatype(d: bytes) -> tuple[np.dtype, tuple | None]:
    """(the dtype h5py reads a datatype message as, and where the value
    sits in the file's bytes when they are not that dtype's: see
    :func:`_convert`; None when they are)."""
    cls, bits, size = d[0] & 0x0F, _u(d, 1, 3), _u(d, 4, 4)
    order = ">" if bits & 0x01 else "<"
    offset, precision = _u(d, 8, 2), _u(d, 10, 2)
    full = (offset, precision) == (0, 8 * size)
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise ValueError(f"HDF5: integers of {size} bytes are not "
                             f"supported")
        kind = "i" if bits & 0x08 else "u"
        dt = np.dtype(f"{order}{kind}{size}")
        # h5py reads one byte as the machine's order: from big-endian at
        # offset 0 libhdf5 converts by its byte swap alone
        # (H5T__conv_order), which keeps the bits past the precision
        swap_only = size == 1 and order == ">" and offset == 0
        return dt, None if full or swap_only else (dt, kind, offset,
                                                   precision)
    if cls == 1:
        sign, layout = (bits >> 8) & 0xFF, (d[12], d[13], d[14], d[15],
                                            _u(d, 16, 4))
        if bits & 0x40:
            raise ValueError("HDF5: floating point in VAX byte order is not "
                             "supported")
        if full and _IEEE.get(size) == layout and sign == size * 8 - 1:
            return np.dtype(f"{order}f{size}"), None
        if (bits >> 4) & 3 != 2:
            raise ValueError("HDF5: floating point without an implied "
                             "mantissa bit is not supported")
        if size not in _IEEE:
            raise ValueError(f"HDF5: floating point of {size} bytes is not "
                             f"supported")
        epos, esize, mpos, msize, bias = layout
        # h5py's dtype: the first numpy float as wide as the file's type
        # that holds its mantissa and exponent range
        for n, fi in _FLOATS:
            if n >= size and msize <= fi.nmant and \
                    2 ** esize - bias - 1 <= fi.maxexp and \
                    1 - bias >= fi.minexp:
                return np.dtype(f"{order}f{n}"), (
                    np.dtype(f"{order}f{size}"), "f", sign, epos, esize,
                    mpos, msize, bias)
        raise ValueError(f"HDF5: floating point of fields {layout} needs a "
                         f"float wider than float64, which is not "
                         f"supported")
    if cls == 8:
        base, fields = _datatype(d[8:])
        if base.kind not in "iu":
            raise ValueError("HDF5: enums of a non-integer base are not "
                             "supported")
        n, version, pos = bits & 0xFFFF, d[0] >> 4, 8 + 12
        names = []
        for _ in range(n):
            end = d.index(b"\0", pos)
            names.append(d[pos:end].decode())
            pos = end + 1
            if version < 3:
                pos = 8 + 12 + (pos - 20 + 7) // 8 * 8
        values = np.frombuffer(d[pos:pos + n * base.itemsize], base)
        # h5py's bool: an 8-bit enum of FALSE = 0 and TRUE = 1
        if base.itemsize == 1 and names == ["FALSE", "TRUE"] and \
                values.tolist() == [0, 1] and fields is None:
            return np.dtype(bool), None
        return base, fields
    raise ValueError(f"HDF5: {CLASS_NAMES.get(cls, f'class {cls}')} "
                     f"datatypes are not supported")


def _convert(raw: bytes, dtype: np.dtype, fields: tuple) -> np.ndarray:
    """Elements whose value sits in bit fields of their bytes, as HDF5
    converts them to h5py's dtype (H5T__conv_i_i, H5T__conv_f_f): an
    integer's ``precision`` bits at ``offset``, sign-extended where
    signed; a float's sign, exponent and mantissa fields, exactly (the
    dtype holds their range), an all-ones exponent infinity or, with a
    mantissa, NaN with every mantissa bit set. Other bits are padding."""
    raw_dt, kind = fields[0], fields[1]
    size = raw_dt.itemsize
    b = np.frombuffer(raw, np.uint8).reshape(-1, size).astype(np.uint64)
    if raw_dt.byteorder == ">":
        b = b[:, ::-1]
    v = (b << (np.arange(size, dtype=np.uint64) * np.uint64(8))).sum(
        1, dtype=np.uint64)

    def field(pos, n):
        return (v >> np.uint64(pos)) & np.uint64((1 << n) - 1)

    if kind in "iu":
        offset, precision = fields[2:]
        x = field(offset, precision)
        if kind == "i":             # the sign bit extended
            high = np.uint64(~((1 << precision) - 1) & 0xFFFFFFFFFFFFFFFF)
            x = np.where(x >> np.uint64(precision - 1) & np.uint64(1),
                         x | high, x).view(np.int64)
        return x.astype(dtype)
    sign, epos, esize, mpos, msize, bias = fields[2:]
    neg, e, m = field(sign, 1) == 1, field(epos, esize), field(mpos, msize)
    special, normal = e == (1 << esize) - 1, e != 0
    mant = (m | (normal.astype(np.uint64) << np.uint64(msize))).astype(
        np.float64)
    x = np.ldexp(mant, np.where(normal & ~special, e, 1).astype(np.int64)
                 - bias - msize)
    x = np.where(special & (m == 0), np.inf, x)
    x = np.where(neg, -x, x).astype(dtype.newbyteorder("="))
    ints = x.view(f"u{dtype.itemsize}")
    top = 8 * dtype.itemsize - 1
    nan = (neg.astype(ints.dtype) << ints.dtype.type(top)) | \
        ints.dtype.type((1 << top) - 1)
    ints[special & (m != 0)] = nan[special & (m != 0)]
    return x.astype(dtype)


def _dataspace(d: bytes) -> tuple[tuple, tuple]:
    """(shape, maxshape) with None for an unlimited dimension; () for a
    scalar."""
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
    dims = tuple(_u(d, off + 8 * i, 8) for i in range(rank))
    if not flags & 1:
        return dims, dims
    maxd = tuple(_u(d, off + 8 * (rank + i), 8) for i in range(rank))
    return dims, tuple(None if m == UNDEF else m for m in maxd)


def _filters(d: bytes) -> list[tuple[int, list[int]]]:
    """(id, client values) of each filter of a pipeline message, in
    pipeline order."""
    version, n = d[0], d[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u(d, pos, 2)
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = _u(d, pos, 2)
            pos += 2
        nvals = _u(d, pos + 2, 2)
        pos += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        pos += name_len
        vals = [_u(d, pos + 4 * i, 4) for i in range(nvals)]
        pos += 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid not in FILTER_NAMES:
            raise ValueError(f"HDF5: filter id {fid} is not supported")
        # H5Znbit's cd_values: count, "need not compress" (every precision
        # the type's own: the chunks pass through), elements, then the
        # type: class (1: atomic), size, order, precision, offset
        if fid == NBIT and not vals[1] and vals[3] != 1:
            raise ValueError("HDF5: the nbit filter over datatypes other "
                             "than numbers is not supported")
        out.append((fid, vals))
    return out


def _link(d: bytes) -> tuple[str, str, object]:
    """(name, "hard" or "soft", address or path) of a link message."""
    flags, pos, kind = d[1], 2, 0
    if flags & 0x08:
        kind = d[pos]
        pos += 1
    if flags & 0x04:
        pos += 8
    if flags & 0x10:
        pos += 1
    width = 1 << (flags & 3)
    n = _u(d, pos, width)
    pos += width
    name = d[pos:pos + n].decode()
    pos += n
    if kind == 0:
        return name, "hard", _u(d, pos, 8)
    if kind == 1:
        return name, "soft", d[pos + 2:pos + 2 + _u(d, pos, 2)].decode()
    if kind == 64:              # flags byte, file name, object path
        file, path = d[pos + 3:pos + 2 + _u(d, pos, 2)].split(b"\0")[:2]
        return name, "external", (file.decode(), path.decode())
    raise ValueError(f"HDF5: user-defined links (type {kind}) are not "
                     f"supported ({name})")


def _btree2_records(rd: _Reader, addr: int) -> tuple[int, list[bytes]]:
    """(record type, every record) of the version 2 B-tree at ``addr``."""
    h = _checked(_signed(rd, addr, 38, b"BTHD"), "v2 B-tree header")
    kind, node_size, rec = h[5], _u(h, 6, 4), _u(h, 10, 2)
    depth, root, nroot = _u(h, 12, 2), _u(h, 16, 8), _u(h, 24, 2)
    # H5B2__hdr_init: records a node holds, and the widths of the counts
    # in the pointers to each level's nodes
    leaf_max = (node_size - 10) // rec
    nrec_size = _enc_size(leaf_max)
    cum, cum_size = [leaf_max], [0]
    for lvl in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[lvl - 1] if lvl > 1 else 0)
        mx = (node_size - (10 + ptr)) // (rec + ptr)
        cum.append((mx + 1) * cum[lvl - 1] + mx)
        cum_size.append(_enc_size(cum[lvl]))
    out = []

    def node(a: int, n: int, lvl: int) -> None:
        if lvl == 0:
            b = _signed(rd, a, 6 + n * rec, b"BTLF")
            out.extend(b[6 + i * rec:6 + (i + 1) * rec] for i in range(n))
            return
        ptr = 8 + nrec_size + (cum_size[lvl - 1] if lvl > 1 else 0)
        b = _signed(rd, a, 6 + n * rec + (n + 1) * ptr, b"BTIN")
        recs = [b[6 + i * rec:6 + (i + 1) * rec] for i in range(n)]
        for i in range(n + 1):
            p = 6 + n * rec + i * ptr
            node(_u(b, p, 8), _u(b, p + 8, nrec_size), lvl - 1)
            if i < n:
                out.append(recs[i])

    if root != UNDEF:
        node(root, nroot, depth)
    return kind, out


class _FractalHeap:
    """The managed and tiny objects of the fractal heap at ``addr``."""

    def __init__(self, rd: _Reader, addr: int):
        h = _signed(rd, addr, 146, b"FRHP")
        self._rd = rd
        self.id_len, filter_len = _u(h, 5, 2), _u(h, 7, 2)
        if filter_len:
            raise ValueError("HDF5: filtered fractal heaps are not "
                             "supported")
        self.max_managed = _u(h, 10, 4)
        self.width = _u(h, 110, 2)
        self.start = _u(h, 112, 8)
        self.max_direct = _u(h, 120, 8)
        self.heap_bits = _u(h, 128, 2)
        self.root = _u(h, 132, 8)
        self.rows = _u(h, 140, 2)
        self.off_size = (self.heap_bits + 7) // 8
        self.len_size = min((self.max_direct.bit_length() + 6) // 8,
                            _enc_size(self.max_managed))
        self.direct_rows = (self.max_direct // self.start).bit_length() + 1

    def _block_size(self, row: int) -> int:
        return self.start if row < 2 else self.start << (row - 1)

    def get(self, hid: bytes) -> bytes:
        kind = (hid[0] >> 4) & 3
        if kind == 2:                       # tiny: in the ID itself
            return hid[1:1 + (hid[0] & 0x0F) + 1]
        if kind != 0:
            raise ValueError("HDF5: huge fractal heap objects are not "
                             "supported")
        off = _u(hid, 1, self.off_size)
        n = _u(hid, 1 + self.off_size, self.len_size)
        if self.rows == 0:                  # the root is a direct block
            return self._rd.read(self.root + off, n)
        return self._indirect(self.root, self.rows, 0, off, n)

    def _indirect(self, addr: int, rows: int, base: int, off: int,
                  n: int) -> bytes:
        pos = base
        for row in range(rows):
            size = self._block_size(row)
            if off < pos + size * self.width:
                col = (off - pos) // size
                start = pos + col * size
                hdr = 5 + 8 + self.off_size
                if row < self.direct_rows:
                    p = hdr + 8 * (row * self.width + col)
                    child = _u(self._rd.read(addr + p, 8), 0, 8)
                    return self._rd.read(child + off - start, n)
                k = min(rows, self.direct_rows) * self.width + \
                    (row - self.direct_rows) * self.width + col
                child = _u(self._rd.read(addr + hdr + 8 * k, 8), 0, 8)
                sub = (size // (self.start * self.width)).bit_length()
                return self._indirect(child, sub, start, off, n)
            pos += size * self.width
        raise ValueError(f"HDF5: fractal heap offset {off} out of range")


def _global_heap_object(rd: _Reader, addr: int, index: int) -> bytes:
    h = _signed(rd, addr, 16, b"GCOL")
    col = rd.read(addr, _u(h, 8, 8))
    pos = 16
    while pos + 16 <= len(col):
        idx, size = _u(col, pos, 2), _u(col, pos + 8, 8)
        if idx == index:
            return col[pos + 16:pos + 16 + size]
        if idx == 0:
            break
        pos += 16 + (size + 7) // 8 * 8
    raise ValueError(f"HDF5: no object {index} in the global heap at "
                     f"{addr}")


def _selection(d: bytes, pos: int, shape: tuple) -> tuple[list, int]:
    """The index lists (one a dimension, row-major product) of an encoded
    "all" or regular hyperslab selection, and the position past it."""
    kind, version = _u(d, pos, 4), _u(d, pos + 4, 4)
    if kind == 3:                                   # all
        return [list(range(n)) for n in shape], pos + 16
    if kind != 2:
        what = {0: "empty", 1: "point"}.get(kind, f"type {kind}")
        raise ValueError(f"HDF5: virtual dataset {what} selections are not "
                         f"supported")
    if version == 2:
        flags, pos, width = d[pos + 8], pos + 13, 8
    elif version == 3:
        flags, width, pos = d[pos + 8], d[pos + 9], pos + 10
    else:
        flags = 0
    if version not in (2, 3) or not flags & 1:
        raise ValueError("HDF5: virtual dataset selections other than "
                         "regular hyperslabs are not supported")
    rank = _u(d, pos, 4)
    pos += 4
    out = []
    unlimited = (1 << (8 * width)) - 1
    for _ in range(rank):
        start, stride, count, block = (_u(d, pos + width * i, width)
                                       for i in range(4))
        pos += 4 * width
        if count == unlimited or block == unlimited:
            raise ValueError("HDF5: unlimited virtual dataset selections "
                             "are not supported")
        out.append([start + i * stride + j for i in range(count)
                    for j in range(block)])
    return out, pos


# ------------------------------------------------------------ filters

def _native(name: str, raw: bytes, cap: int, *args) -> bytes:
    """lzf into a buffer of ``cap`` bytes, grown by the input's size while
    it is too small (h5py's lzf filter: what an earlier filter wrote may
    be larger than the chunk, as scaleoffset's header makes it); szip
    into the size its first four bytes give (H5Z__filter_szip)."""
    from classpose_tpu_torch.native import load_hdf5filters

    lib = load_hdf5filters()
    if name == "lzf":
        while True:
            out = np.empty(max(cap, 1), np.uint8)
            n = lib.h5_lzf_decode(raw, len(raw), out.ctypes.data, cap)
            if n != -2:
                break
            cap += max(len(raw), 1)
        if n < 0:
            raise ValueError("HDF5: lzf chunk is corrupt")
    else:
        cap = _u(raw, 0, 4) if len(raw) >= 4 else 0
        # zeros where libaec leaves a last, partial pixel unwritten
        out = np.zeros(max(cap, 1), np.uint8)
        err = ctypes.create_string_buffer(256)
        n = lib.h5_szip_decode(raw, len(raw), out.ctypes.data, cap, *args,
                               err, 256)
        if n < 0:
            raise ValueError(f"HDF5: {err.value.decode()}")
    return out[:n].tobytes()


def _nbit(raw: bytes, vals: list[int]) -> bytes:
    """H5Znbit.c's decompression of an atomic type: each element's
    ``precision`` bits, packed MSB first one element after another, put
    back at its ``offset`` in an element of ``size`` bytes of its byte
    order; every other bit zero."""
    count, size, big, precision, offset = vals[2], vals[4], vals[5], \
        vals[6], vals[7]
    if not 0 < precision <= 8 * size - offset:
        raise ValueError("HDF5: nbit precision and offset do not fit the "
                         "datatype")
    nbits = count * precision
    if len(raw) * 8 < nbits:
        raise ValueError("HDF5: nbit chunk is shorter than its elements")
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, (nbits + 7) // 8))
    bits = bits[:nbits].reshape(count, precision).astype(np.uint64)
    v = (bits << np.arange(precision - 1, -1, -1, dtype=np.uint64)).sum(
        1, dtype=np.uint64) << np.uint64(offset)
    out = v.astype("<u8").view(np.uint8).reshape(count, 8)[:, :size]
    return (out[:, ::-1] if big else out).tobytes()


def _unshuffle(raw: bytes, size: int) -> bytes:
    n = len(raw) // size
    if size <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return body.T.tobytes() + raw[n * size:]


def _fletcher32(data: bytes) -> int:
    """H5_checksum_fletcher32: big-endian 16-bit words (an odd last byte
    the high byte of one), sums kept in ones' complement."""
    w = np.frombuffer(data[:len(data) // 2 * 2], ">u2").astype(np.int64)
    if len(data) % 2:
        w = np.append(w, np.int64(data[-1]) << 8)
    n = len(w)
    s1 = int(w.sum() % 65535)
    s2 = int(((np.arange(n, 0, -1, dtype=np.int64) % 65535) * w).sum()
             % 65535)
    nonzero = bool(w.any())

    def fold(s):
        return (s or 65535) if nonzero else 0

    return (fold(s2) << 16) | fold(s1)


def _scaleoffset(raw: bytes, vals: list[int], dtype: np.dtype,
                 count: int) -> bytes:
    """H5Zscaleoffset.c's decompression: minbits, minval, the packed
    values (MSB first), then the integer or float D-scale
    postprocessing with the fill value."""
    scale_type, factor, cls, size = vals[0], vals[1], vals[3], vals[4]
    if cls == 1 and scale_type != 0:
        raise ValueError("HDF5: scaleoffset E-scaling is not supported")
    minbits = _u(raw, 0, 4)
    msize = min(8, raw[4])
    minval = _u(raw, 5, msize)
    native = dtype.newbyteorder("=")
    if minbits == size * 8:
        out = np.frombuffer(raw[21:21 + count * size], native)
        return out.astype(dtype).tobytes()
    ints = np.dtype(f"<{'u' if cls == 0 else 'i'}{size}")
    if minbits:
        nbits = count * minbits
        bits = np.unpackbits(np.frombuffer(raw[21:21 + (nbits + 7) // 8],
                                           np.uint8))[:nbits]
        packed = bits.reshape(count, minbits).astype(np.uint64)
        packed = (packed << np.arange(minbits - 1, -1, -1,
                                      dtype=np.uint64)).sum(1,
                                                            dtype=np.uint64)
    else:
        packed = np.zeros(count, np.uint64)
    all_ones = (np.uint64(1) << np.uint64(minbits)) - np.uint64(1) \
        if minbits < 64 else np.uint64(UNDEF)
    fill_bytes = b"".join(v.to_bytes(4, "little") for v in vals[8:])
    fill = np.frombuffer(fill_bytes[:size], native)[0] if vals[7] else None
    is_fill = packed == all_ones
    if cls == 0:   # wraps as the C integer type does
        out = (packed + np.uint64(minval)).astype(f"<u{size}").view(
            f"<{dtype.kind}{size}")
    else:
        mn = np.frombuffer(minval.to_bytes(8, "little")[:size],
                           f"<f{size}")[0]
        ft = mn.dtype.type
        out = (packed.astype(ints).astype(ft) / ft(10.0 ** factor)
               + mn).astype(f"<f{size}")
    out = out.astype(native)
    if fill is not None:
        out = np.where(is_fill, fill, out).astype(native)
    return out.astype(dtype).tobytes()


# ------------------------------------------------------------ chunk indexes

def _grid(dims, chunks) -> list[int]:
    return [-(-d // c) for d, c in zip(dims, chunks)]


def _entry(b: bytes, pos: int, size: int, filtered: bool, full: int):
    """(address, stored bytes, filter mask) of a chunk index entry."""
    addr = _u(b, pos, 8)
    if not filtered:
        return addr, full, 0
    return addr, _u(b, pos + 8, size - 12), _u(b, pos + size - 4, 4)


def _fixed_array(rd, addr, full):
    h = _checked(_signed(rd, addr, 28, b"FAHD"), "fixed array header")
    filtered, esize, page_bits = h[5] == 1, h[6], h[7]
    n, dblk = _u(h, 8, 8), _u(h, 16, 8)
    if dblk == UNDEF:
        return []
    page = 1 << page_bits
    out = []
    if n <= page:
        b = _signed(rd, dblk, 14 + n * esize, b"FADB")
        return [_entry(b, 14 + i * esize, esize, filtered, full)
                for i in range(n)]
    npages = -(-n // page)
    bitmap = rd.read(dblk + 14, (npages + 7) // 8)
    pos = dblk + 14 + len(bitmap) + 4
    for p in range(npages):
        k = min(page, n - p * page)
        if bitmap[p // 8] & (0x80 >> (p % 8)):
            b = rd.read(pos, k * esize)
            out += [_entry(b, i * esize, esize, filtered, full)
                    for i in range(k)]
        else:
            out += [(UNDEF, 0, 0)] * k
        pos += k * esize + 4
    return out


def _extensible_array(rd, addr, full, count):
    """The first ``count`` entries of the extensible array at ``addr``
    (H5EA: index block elements, then super blocks of data blocks)."""
    h = _checked(_signed(rd, addr, 72, b"EAHD"), "extensible array header")
    filtered, esize, max_bits = h[5] == 1, h[6], h[7]
    idx_elmts, dblk_min, sblk_min, page_bits = h[8], h[9], h[10], h[11]
    iblock = _u(h, 60, 8)
    if iblock == UNDEF:
        return []
    off_size = (max_bits + 7) // 8
    nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
    sinfo, start_idx, start_dblk = [], 0, 0
    for s in range(nsblks):
        nd, ne = 1 << (s // 2), (1 << ((s + 1) // 2)) * dblk_min
        sinfo.append((nd, ne, start_idx, start_dblk))
        start_idx += nd * ne
        start_dblk += nd
    ib_sblks = 2 * (sblk_min.bit_length() - 1)
    ndblk_addrs, nsblk_addrs = 2 * (sblk_min - 1), nsblks - ib_sblks
    ib = _signed(rd, iblock, 14 + idx_elmts * esize
                 + 8 * (ndblk_addrs + nsblk_addrs), b"EAIB")
    out = [_entry(ib, 14 + i * esize, esize, filtered, full)
           for i in range(min(idx_elmts, count))]
    daddr = [_u(ib, 14 + idx_elmts * esize + 8 * i, 8)
             for i in range(ndblk_addrs)]
    saddr = [_u(ib, 14 + idx_elmts * esize + 8 * (ndblk_addrs + i), 8)
             for i in range(nsblk_addrs)]
    blocks = {}

    def dblock(a, ne):
        if a not in blocks:
            if ne > (1 << page_bits):
                raise ValueError("HDF5: paged extensible array data blocks "
                                 "are not supported")
            blocks[a] = _signed(rd, a, 14 + off_size + ne * esize, b"EADB")
        return blocks[a]

    for i in range(idx_elmts, count):
        j = i - idx_elmts
        s = (j // dblk_min + 1).bit_length() - 1
        nd, ne, s_start, s_dblk = sinfo[s]
        if s < ib_sblks:
            a = daddr[s_dblk + (j - s_start) // ne]
        else:
            sa = saddr[s - ib_sblks]
            if sa == UNDEF:
                out.append((UNDEF, 0, 0))
                continue
            sb = _signed(rd, sa, 14 + off_size + 8 * nd, b"EASB")
            a = _u(sb, 14 + off_size + 8 * ((j - s_start) // ne), 8)
        if a == UNDEF:
            out.append((UNDEF, 0, 0))
            continue
        b = dblock(a, ne)
        out.append(_entry(b, 14 + off_size + ((j - s_start) % ne) * esize,
                          esize, filtered, full))
    return out


def _btree1_chunks(rd, addr, ndims):
    """Chunk origin → (address, stored bytes, filter mask) over the
    version 1 chunk B-tree at ``addr``, every level walked."""
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
    ``maxshape``, ``chunks`` (None unless chunked), the filters as h5py
    names them, ``ds[i]``/``ds[a:b]`` on axis 0, ``ds[()]`` and
    ``np.asarray(ds)``."""

    def __init__(self, file: "File", name: str,
                 msgs: list[tuple[int, int, bytes]]):
        self._file = file
        self._rd = file._rd
        self.name = name
        self.shape: tuple[int, ...] = ()
        self.maxshape: tuple = ()
        self.dtype: np.dtype | None = None
        self.chunks: tuple[int, ...] | None = None
        self._filters: list[tuple[int, list[int]]] = []
        self._fields = None
        self._itemsize = 0              # bytes an element takes in the file
        self._fill = None
        self._index = None
        self._external = None
        layout = None
        for mtype, flags, d in msgs:
            if flags & 0x02 and mtype in (DATASPACE, DATATYPE, FILL,
                                          FILTERS, EXTERNAL):
                d = file._shared_message(mtype, d)
            if mtype == DATASPACE:
                self.shape, self.maxshape = _dataspace(d)
            elif mtype == DATATYPE:
                self.dtype, self._fields = _datatype(d)
                self._itemsize = _u(d, 4, 4)
            elif mtype == FILL:
                self._fill = d
            elif mtype == LAYOUT:
                layout = d
            elif mtype == FILTERS:
                self._filters = _filters(d)
            elif mtype == EXTERNAL:
                self._external = d
        if layout is None or self.dtype is None:
            raise ValueError(f"HDF5: {name} is not a dataset")
        self._layout(layout)

    def _layout(self, d: bytes) -> None:
        version, self._kind = d[0], d[1]
        if version not in (3, 4):
            raise ValueError(f"HDF5: layout message version {version} is "
                             f"not supported (versions 3 and 4)")
        if self._kind == 0:
            self._compact = d[4:4 + _u(d, 2, 2)]
        elif self._kind == 1:
            self._addr, self._size = _u(d, 2, 8), _u(d, 10, 8)
        elif self._kind == 2 and version == 3:
            ndims = d[2]
            self._addr = _u(d, 3, 8)
            dims = [_u(d, 11 + 4 * i, 4) for i in range(ndims)]
            self.chunks = tuple(dims[:-1])
            self._index_kind, self._index_info = 0, None
        elif self._kind == 2:
            flags, ndims, width = d[2], d[3], d[4]
            dims = [_u(d, 5 + width * i, width) for i in range(ndims)]
            self.chunks = tuple(dims[:-1])
            pos = 5 + width * ndims
            self._index_kind = d[pos]
            pos += 1
            info = {1: 12 if flags & 2 else 0, 2: 0, 3: 1, 4: 5, 5: 6}
            if self._index_kind not in info:
                raise ValueError(f"HDF5: chunk index type "
                                 f"{self._index_kind} is not supported")
            self._index_info = d[pos:pos + info[self._index_kind]]
            self._addr = _u(d, pos + info[self._index_kind], 8)
        elif self._kind == 3:
            self._vds = (_u(d, 2, 8), _u(d, 10, 4))
        else:
            raise ValueError(f"HDF5: layout class {self._kind} is not "
                             f"supported")

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("a scalar dataset has no length")
        return self.shape[0]

    # h5py's names of the pipeline
    def _has(self, fid: int) -> bool:
        return any(f == fid for f, _ in self._filters)

    @property
    def compression(self) -> str | None:
        for fid, name in ((DEFLATE, "gzip"), (LZF, "lzf"), (SZIP, "szip")):
            if self._has(fid):
                return name
        return None

    @property
    def compression_opts(self):
        for fid, vals in self._filters:
            if fid == DEFLATE:
                return vals[0] if vals else None
            if fid == SZIP:
                return ("nn" if vals[0] & 32 else "ec", vals[1])
        return None

    @property
    def shuffle(self) -> bool:
        return self._has(SHUFFLE)

    @property
    def fletcher32(self) -> bool:
        return self._has(FLETCHER32)

    @property
    def scaleoffset(self):
        for fid, vals in self._filters:
            if fid == SCALEOFFSET:
                return vals[1]
        return None

    def _fill_value(self):
        """The fill value where the message defines one, else 0."""
        d = self._fill
        if d is None or d[0] not in (2, 3):
            return np.zeros((), self.dtype)[()]
        if d[0] == 2:
            if not d[3]:
                return np.zeros((), self.dtype)[()]
            size, val = _u(d, 4, 4), d[8:]
        else:
            if not d[1] & 0x20:
                return np.zeros((), self.dtype)[()]
            size, val = _u(d, 2, 4), d[6:]
        if size == 0:
            return np.zeros((), self.dtype)[()]
        return self._decode(val[:size], 1)[0]

    def _decode(self, raw: bytes, count: int) -> np.ndarray:
        """``count`` elements from the file's bytes, as h5py reads them."""
        if self._fields is None:
            return np.frombuffer(raw, self.dtype, count)
        return _convert(raw[:count * self._itemsize], self.dtype,
                        self._fields)

    # ------------------------------------------------------------ reading
    def _all(self) -> np.ndarray:
        """The whole dataset, C-ordered."""
        if not self.shape or self._kind != 2:
            return self._whole()
        return self._rows(0, self.shape[0])

    def _whole(self) -> np.ndarray:
        n = int(np.prod(self.shape, dtype=np.int64))
        if self._kind == 0:
            raw = self._compact[:n * self._itemsize]
        elif self._kind == 3:
            return self._virtual()
        elif self._external is not None:
            raw = self._external_bytes(n * self._itemsize)
        elif self._addr == UNDEF:
            return np.full(self.shape, self._fill_value(), self.dtype)
        else:
            raw = self._rd.read(self._addr, n * self._itemsize)
        return self._decode(raw, n).reshape(self.shape).copy()

    def _external_bytes(self, n: int) -> bytes:
        """The dataset's bytes from its external files: each slot's name
        (from the message's local heap), offset and size, in order; a
        relative name is taken from the working directory, as HDF5 does
        without an external-file prefix."""
        d = self._external
        used, heap = _u(d, 6, 2), _u(d, 8, 8)
        h = _signed(self._rd, heap, 32, b"HEAP")
        names = self._rd.read(_u(h, 24, 8), _u(h, 8, 8))
        out = bytearray()
        for i in range(used):
            off = 16 + 24 * i
            name_off, start, size = (_u(d, off + 8 * k, 8) for k in range(3))
            name = names[name_off:names.index(b"\0", name_off)].decode()
            prefix = os.environ.get("HDF5_EXTFILE_PREFIX", "")
            with open(os.path.join(prefix, name) if prefix else name,
                      "rb") as fh:
                fh.seek(start)
                take = min(size, n - len(out)) if size != UNDEF else \
                    n - len(out)
                chunk = fh.read(take)
            if len(chunk) < take:
                raise ValueError(f"HDF5: external file {name} is shorter "
                                 f"than its slot")
            out += chunk
            if len(out) >= n:
                break
        if len(out) < n:
            raise ValueError("HDF5: external storage holds fewer bytes than "
                             "the dataset")
        return bytes(out)

    def _virtual(self) -> np.ndarray:
        """H5D virtual: each mapping copies its source selection of a
        source dataset into its virtual selection, in row-major order; the
        fill value where none maps or a source is missing."""
        out = np.full(self.shape, self._fill_value(), self.dtype)
        addr, index = self._vds
        d = _global_heap_object(self._rd, addr, index)
        if d[0] != 0:
            raise ValueError(f"HDF5: virtual dataset mapping encoding "
                             f"version {d[0]} is not supported")
        n, pos = _u(d, 1, 8), 9
        for _ in range(n):
            end = d.index(b"\0", pos)
            src_file = d[pos:end].decode()
            pos = end + 1
            end = d.index(b"\0", pos)
            src_name = d[pos:end].decode()
            pos = end + 1
            if "%" in src_file or "%" in src_name:
                raise ValueError("HDF5: printf-style virtual dataset source "
                                 "names are not supported")
            src = self._file._source(src_file, src_name)
            sshape = src.shape if src is not None else ()
            ssel, pos = _selection(d, pos, sshape)
            vsel, pos = _selection(d, pos, self.shape)
            if src is None:
                continue
            vals = np.asarray(src)[np.ix_(*ssel)].reshape(-1)
            out[np.ix_(*vsel)] = vals.reshape([len(v) for v in vsel])
        return out

    def _chunk_index(self) -> dict:
        c = self.chunks
        full = int(np.prod(c, dtype=np.int64)) * self._itemsize
        kind, info = self._index_kind, self._index_info
        if self._addr == UNDEF:
            return {}
        if kind == 0:
            return _btree1_chunks(self._rd, self._addr, len(c) + 1)
        if kind == 1:                               # single chunk
            if info:
                return {(0,) * len(c): (self._addr, _u(info, 0, 8),
                                        _u(info, 8, 4))}
            return {(0,) * len(c): (self._addr, full, 0)}
        if kind == 5:                               # v2 B-tree
            rtype, recs = _btree2_records(self._rd, self._addr)
            out = {}
            for r in recs:
                scaled = [_u(r, len(r) - 8 * (len(c) - i), 8)
                          for i in range(len(c))]
                origin = tuple(s * k for s, k in zip(scaled, c))
                if rtype == 11:
                    size = len(r) - 8 * len(c)
                    out[origin] = (_u(r, 0, 8), _u(r, 8, size - 12),
                                   _u(r, size - 4, 4))
                else:
                    out[origin] = (_u(r, 0, 8), full, 0)
            return out
        # implicit, fixed and extensible arrays: entries in row-major order
        # over the chunk grid of the maximum dimensions, an unlimited one
        # (the extensible array's) first
        unlim = [i for i, m in enumerate(self.maxshape) if m is None]
        dims = [self.shape[i] if self.maxshape[i] is None
                else self.maxshape[i] for i in range(len(c))]
        order = unlim + [i for i in range(len(c)) if i not in unlim]
        grid = _grid([dims[i] for i in order], [c[i] for i in order])
        count = int(np.prod(grid, dtype=np.int64))
        if kind == 2:
            entries = [(self._addr + i * full, full, 0) for i in range(count)]
        elif kind == 3:
            entries = _fixed_array(self._rd, self._addr, full)
        else:
            entries = _extensible_array(self._rd, self._addr, full, count)
        out = {}
        for idx, e in zip(np.ndindex(*grid), entries):
            if e[0] == UNDEF:
                continue
            origin = [0] * len(c)
            for k, i in zip(idx, order):
                origin[i] = k * c[i]
            out[tuple(origin)] = e
        return out

    def _rows(self, a: int, b: int) -> np.ndarray:
        """Rows a..b (axis 0) as a C-ordered array."""
        shape = (b - a,) + self.shape[1:]
        if self._kind != 2:
            return self._all()[a:b].copy()
        out = np.full(shape, self._fill_value(), self.dtype)
        if self._index is None:
            self._index = self._chunk_index()
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
        count = int(np.prod(self.chunks, dtype=np.int64))
        full = count * self._itemsize
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, vals = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == SHUFFLE:
                raw = _unshuffle(raw, vals[0] if vals else
                                 self._itemsize)
            elif fid == FLETCHER32:
                body, stored = raw[:-4], _u(raw, len(raw) - 4, 4)
                s = _fletcher32(body)
                swapped = ((s & 0xFF00FF00) >> 8) | ((s & 0x00FF00FF) << 8)
                if stored not in (s, swapped):
                    raise ValueError(f"HDF5: {self.name}: data error "
                                     f"detected by Fletcher32 checksum")
                raw = body
            elif fid == LZF:
                raw = _native("lzf", raw, full)
            elif fid == SZIP:
                raw = _native("szip", raw, full, *vals[:4])
            elif fid == SCALEOFFSET:
                raw = _scaleoffset(raw, vals, self._fields[0] if self._fields
                                   else self.dtype, count)
            elif fid == NBIT and not vals[1]:
                raw = _nbit(raw, vals)
        return self._decode(raw, count).reshape(self.chunks)

    def __getitem__(self, key):
        if isinstance(key, tuple):
            if key == ():
                return self._all()[()]
            if len(key) != 1:
                raise IndexError("only axis 0 is indexed")
            key = key[0]
        if not self.shape:
            raise IndexError("a scalar dataset takes () or ...")
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
        out = self._all()
        return out if dtype is None else out.astype(dtype)


class File:
    """A read-only HDF5 file of the layout in the module docstring: a
    mapping of dataset name → :class:`Dataset`."""

    def __init__(self, path):
        self.path = str(path)
        self._fh = open(self.path, "rb")
        self._sources: dict[str, File] = {}
        try:
            self._rd = _Reader(self._fh)
            self._datasets: dict[str, Dataset] = {}
            self._groups: set[str] = set()
            self._soft: dict[str, str] = {}
            self._external: dict[str, tuple[str, str]] = {}
            self._dangling: dict[str, bool] = {}    # name -> in a cycle
            self._sohm: dict[int, _FractalHeap] = {}  # type -> its heap
            root = self._superblock()
            self._walk(root, "", set())
            self._resolve_soft_links()
        except BaseException:
            self.close()
            raise

    def _superblock(self) -> int:
        b = self._rd.read(0, 8 + 16)
        if b[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (at offset 0)")
        version = b[8]
        if version in (2, 3):
            if b[9] != 8 or b[10] != 8:
                raise ValueError("HDF5: offsets and lengths of other than "
                                 "8 bytes are not supported")
            sb = _checked(self._rd.read(0, 48), "superblock")
            if _u(sb, 12, 8) != 0:
                raise ValueError("HDF5: a base address other than 0 is not "
                                 "supported")
            if _u(sb, 20, 8) != UNDEF:
                self._shared_table(_u(sb, 20, 8))
            return _u(sb, 36, 8)
        if version not in (0, 1):
            raise ValueError(f"HDF5: superblock version {version} is not "
                             f"supported")
        if b[13] != 8 or b[14] != 8:
            raise ValueError("HDF5: offsets and lengths of other than 8 "
                             "bytes are not supported")
        start = 24 + (4 if version == 1 else 0)
        sb = self._rd.read(start, 32 + 40)
        if _u(sb, 0, 8) != 0:
            raise ValueError("HDF5: a base address other than 0 is not "
                             "supported")
        return _u(sb, 32 + 8, 8)     # root entry's object header

    def _shared_table(self, ext: int) -> None:
        """The shared message table named in the superblock extension (an
        object header at ``ext``): each ``SMTB`` index's message types and
        the fractal heap that holds its messages. An index's list
        (``SMLI``) or version 2 B-tree of records is not read: a shared
        message gives its heap ID, and HDF5 reads it from the heap alone
        (H5SM_get_fheap_addr)."""
        for mtype, _, d in _messages(self._rd, ext):
            if mtype != SHARED_TABLE:
                continue
            addr, n = _u(d, 1, 8), d[9]
            t = _checked(_signed(self._rd, addr, 8 + 30 * n, b"SMTB"),
                         "shared message table")
            for i in range(n):
                e = t[4 + 30 * i:4 + 30 * (i + 1)]
                heap = _FractalHeap(self._rd, _u(e, 22, 8))
                self._sohm.update({k: heap for k in range(16)
                                   if _u(e, 2, 2) >> k & 1})

    def _shared_message(self, mtype: int, d: bytes) -> bytes:
        """The body of a shared message of type ``mtype``: from the shared
        message heap of the index that takes its type, or from the object
        header that holds it (a committed datatype's)."""
        in_heap, where = _shared(d)
        if in_heap:
            if mtype not in self._sohm:
                raise ValueError(f"HDF5: a message of type {mtype} is "
                                 f"shared, but no shared message index "
                                 f"takes its type")
            return self._sohm[mtype].get(where)
        for t, _, body in _messages(self._rd, where):
            if t == mtype:
                return body
        raise ValueError(f"HDF5: no message of type {mtype} in the object "
                         f"header at {where}")

    def _links(self, msgs) -> list[tuple[str, str, object]] | None:
        """The links of a group's header, or None for a dataset."""
        types = {m[0] for m in msgs}
        if SYMBOL_TABLE in types:
            d = next(d for t, _, d in msgs if t == SYMBOL_TABLE)
            btree, heap = _u(d, 0, 8), _u(d, 8, 8)
            h = _signed(self._rd, heap, 32, b"HEAP")
            names = self._rd.read(_u(h, 24, 8), _u(h, 8, 8))

            def text(off):
                return names[off:names.index(b"\0", off)].decode()

            # cache type 2: a soft link, its value at the scratch pad's
            # offset into the same heap (the header address is UNDEF)
            return [(text(off), "soft", text(_u(pad, 0, 4))) if cache == 2
                    else (text(off), "hard", obj)
                    for off, obj, cache, pad in self._symbols(btree)]
        if LINK_INFO not in types and LINK not in types:
            return None
        links = [_link(d) for t, _, d in msgs if t == LINK]
        for t, _, d in msgs:
            if t != LINK_INFO:
                continue
            pos = 2 + (8 if d[1] & 1 else 0)
            heap, names = _u(d, pos, 8), _u(d, pos + 8, 8)
            if heap == UNDEF:
                continue
            fh = _FractalHeap(self._rd, heap)
            _, recs = _btree2_records(self._rd, names)
            links += [_link(fh.get(r[4:4 + fh.id_len])) for r in recs]
        return links

    def _walk(self, addr: int, prefix: str, seen: set) -> None:
        msgs = _messages(self._rd, addr)
        links = self._links(msgs)
        name = prefix.rstrip("/")
        if links is None:
            if any(t == LAYOUT for t, _, _ in msgs):
                self._datasets[name] = Dataset(self, name, msgs)
            return                          # a committed datatype
        if addr in seen:
            return
        self._groups.add(name)
        seen = seen | {addr}
        for lname, kind, value in links:
            if kind == "hard":
                self._walk(value, f"{prefix}{lname}/", seen)
            elif kind == "soft":
                self._soft[f"{prefix}{lname}"] = value
            else:
                self._external[f"{prefix}{lname}"] = value

    def _resolve_soft_links(self) -> None:
        """Soft links as HDF5 follows them: a link to a dataset (or an
        external link) is another name of it; a link to a group names
        every dataset and link under it, except where that group is
        already on the link's path (a cycle of links, which h5py lists
        but never walks). A link waits while its target is itself a link
        not yet resolved, so chains resolve in turn. What never resolves
        stays a dangling name, listed as h5py lists it: its target is
        missing (``KeyError`` when read, as in h5py) or its chain is a
        cycle (an error naming it, where h5py raises "too many links")."""

        def target(name):
            base = name.rsplit("/", 1)[0] + "/" if "/" in name else ""
            t = self._soft[name]
            return (t if t.startswith("/") else base + t).strip("/")

        # pending link -> the groups that links on its path already entered;
        # the path guard ends every cycle, the bound a pathological file
        pending = dict.fromkeys(self._soft, frozenset())
        for _ in range(NUM_LINKS * NUM_LINKS):
            done = []
            for name, path in list(pending.items()):
                t = target(name)
                if t in self._datasets:
                    self._datasets[name] = self._datasets[t]
                elif t in self._external:
                    self._external[name] = self._external[t]
                elif t in self._groups:
                    if not _under(name, t) and t not in path:
                        self._enter(name, t, path | {t}, pending)
                elif t not in self._soft:
                    continue                # missing: dangling
                else:
                    continue                # waits for the link it names
                done.append(name)
            if not done:
                break
            for name in done:
                pending.pop(name)
        for name in pending:
            seen, t = {name}, target(name)
            while t in self._soft and t not in seen:
                seen.add(t)
                t = target(t)
            self._dangling[name] = t in seen

    def _enter(self, name: str, t: str, path: frozenset,
               pending: dict) -> None:
        """The names under group ``t`` again under the link ``name``: its
        datasets, groups and links (the soft ones to be resolved there)."""
        for table in (self._datasets, self._external, self._soft):
            for k, v in list(table.items()):
                if _under(k, t):
                    table[name + k[len(t):]] = v
                    if table is self._soft:
                        pending[name + k[len(t):]] = path
        self._groups |= {name + g[len(t):] for g in self._groups
                         if _under(g, t)}

    def _source(self, src_file: str, name: str) -> Dataset | None:
        """A virtual dataset's source, or None where it is missing (HDF5
        fills those): "." is this file; another name is looked up from
        this file's directory."""
        try:
            if src_file == ".":
                f = self
            else:
                path = os.path.join(os.path.dirname(self.path), src_file)
                if path not in self._sources:
                    self._sources[path] = File(path)
                f = self._sources[path]
            return f[name]
        except (OSError, KeyError):
            return None

    def _symbols(self, addr: int) -> list[tuple[int, int, int, bytes]]:
        """(name offset in the heap, object header address, cache type,
        scratch pad) of every entry under the group B-tree node at
        ``addr``."""
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
            out += [(_u(ents, 40 * j, 8), _u(ents, 40 * j + 8, 8),
                     _u(ents, 40 * j + 16, 4), ents[40 * j + 24:40 * j + 40])
                    for j in range(n)]
        return out

    def _extern_file(self, name: str, file: str) -> "File":
        """The file an external link names, found as HDF5 1.14 finds it
        (without ``HDF5_EXT_PREFIX``): an absolute name as is, then (by
        its last component if that failed) beside this file and from the
        working directory; opened once."""
        tries = [file] if os.path.isabs(file) else []
        base = os.path.basename(file) if tries else file
        tries += [os.path.join(os.path.dirname(self.path), base), base]
        for path in tries:
            key = os.path.abspath(path)
            if key in self._sources:
                return self._sources[key]
            if os.path.isfile(path):
                self._sources[key] = File(path)
                return self._sources[key]
        raise ValueError(f"HDF5: {name} is an external link to {file}, "
                         f"which was not found (external links are looked "
                         f"up as given, beside {self.path} and from the "
                         f"working directory)")

    def _get(self, name: str, depth: int) -> Dataset:
        name = name.strip("/")
        if name in self._datasets:
            return self._datasets[name]
        if self._dangling.get(name):
            raise ValueError(f"HDF5: {name}: too many links (its soft links "
                             f"form a cycle)")
        for link, (file, path) in self._external.items():
            if name != link and not name.startswith(link + "/"):
                continue
            if depth >= NUM_LINKS:
                raise ValueError(f"HDF5: {name}: too many links (more than "
                                 f"{NUM_LINKS} external links followed)")
            target = self._extern_file(name, file)
            inner = path.strip("/") + name[len(link):]
            try:
                return target._get(inner, depth + 1)
            except KeyError:
                raise ValueError(f"HDF5: {name} is an external link to "
                                 f"{file}:{path}, and {inner or '/'} is not "
                                 f"a dataset there") from None
        raise KeyError(name)

    def __getitem__(self, name: str) -> Dataset:
        """The dataset of that name; an external link is followed here,
        when its name is read, as h5py follows it."""
        return self._get(name, 0)

    def __contains__(self, name) -> bool:
        name = str(name).strip("/")
        if name in self._datasets or name in self._external or \
                name in self._dangling:
            return True
        try:                                # under an external group
            self._get(name, 0)
        except (KeyError, ValueError):
            return False
        return True

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.keys())

    def keys(self):
        """Dataset names, then the names of external links (not followed)
        and of dangling soft links: h5py lists a link whether or not its
        target can be read."""
        return list(self._datasets) + [k for k in self._external
                                       if k not in self._datasets] + \
            list(self._dangling)

    def get(self, name: str, default=None):
        """``f[name]``, or ``default`` where h5py's ``get`` gives it: the
        name is missing or a dangling soft link."""
        try:
            return self[name]
        except KeyError:
            return default

    def close(self) -> None:
        sources, self._sources = self._sources, {}
        for f in sources.values():
            f.close()
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _under(name: str, group: str) -> bool:
    """Whether ``name`` lies under ``group`` ("" is the root)."""
    return not group or name.startswith(group + "/")


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
