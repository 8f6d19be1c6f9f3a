"""The port's HDF5 reader (``classpose_tpu_torch/io/hdf5.py``) against
h5py 3.14 / libhdf5 1.14.6 on what h5py writes with soft links at its
defaults, lzf and szip after scaleoffset, shared object header messages
and the nbit filter at reduced precision, on the CPU:

- the goldens of ``tests/golden/regenerate_hdf5.py`` under ``"more"`` in
  ``hdf5_golden.json`` (a training file whose arrays are soft links in an
  old-style group, shared messages indexed by a list and by a B-tree,
  nbit datasets), read by both to the recorded digests, the names listed
  alike, and the JAX ``ClassposeHDF5Dataset`` against the port's on the
  training file;
- sweeps built here: soft links to datasets and groups (absolute,
  relative, chained, dangling, in a cycle) in old-style and new-style
  groups; lzf and szip after scaleoffset at chunks of 8 to 512 values,
  on both sides of the size where scaleoffset's output outgrows the
  chunk; nbit over integers and floats at several precisions, offsets
  and field layouts in both byte orders; shared messages under both
  index forms, both header versions and a minimum message size;
- array and compound types under nbit, and a float h5py reads as
  ``float128``, raise by name."""

import hashlib
import json
from pathlib import Path

import h5py
import numpy as np
import pytest

import classpose_tpu.train.dataset as jax_dataset
import classpose_tpu_torch.train.dataset as port_dataset
from classpose_tpu_torch.io import hdf5
from golden import regenerate_hdf5 as regen

GOLDEN = Path(__file__).parent / "golden"
MORE = json.loads((GOLDEN / regen.JSON_NAME).read_text())["more"]


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _same_as_h5py(path, rows: bool = True) -> list[str]:
    """Every dataset name h5py gives (soft links followed) read by the port
    to h5py's dtype, shape and bytes, whole and (``rows``) by rows; the
    names the port lists are h5py's, dangling soft links included, and
    each dangling name is ``in`` both files and read by neither."""
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        want, dangling = regen.listing(ref)
        assert sorted(f) == sorted(list(want) + dangling)
        for name in want:
            a = ref[name][()]
            assert bits_equal(f[name][()], a), name
            assert bits_equal(np.asarray(f[name]), a), name
            if rows and a.ndim and len(a) > 2:
                assert bits_equal(f[name][1:3], ref[name][1:3]), name
                assert bits_equal(f[name][-1], ref[name][-1]), name
        for name in dangling:
            assert name in ref and name in f
            assert ref.get(name) is None and f.get(name) is None
            with pytest.raises(KeyError):
                ref[name]
            with pytest.raises(KeyError):
                f[name]
    return list(want)


# ------------------------------------------------------------- the goldens

@pytest.mark.parametrize("name", list(MORE))
def test_golden(name):
    """Each golden read by h5py and by the port to the digests that
    ``chip_smoke.py`` checks on the card, with the same names."""
    spec = MORE[name]
    path = GOLDEN / name
    assert path.stat().st_size <= 64 * 1024
    assert sorted(_same_as_h5py(path)) == sorted(spec["datasets"])
    with hdf5.File(path) as f:
        assert sorted(f) == sorted(list(spec["datasets"]) + spec["dangling"])
        for k, want in spec["datasets"].items():
            a = np.asarray(f[k][()])
            assert [a.dtype.str, list(a.shape),
                    hashlib.sha256(a.tobytes()).hexdigest()] == \
                [want["dtype"], want["shape"], want["sha256"]], k


def test_golden_default_structure():
    """The training golden is h5py's default layout (superblock 0,
    symbol-table groups), its arrays named at the root by soft links;
    ``instance_counts`` is lzf after scaleoffset; the shared goldens'
    indexes are a list and a version 2 B-tree."""
    raw = (GOLDEN / regen.DEFAULT_NAME).read_bytes()
    assert raw[8] == 0 and b"SNOD" in raw and b"OHDR" not in raw
    with h5py.File(GOLDEN / regen.DEFAULT_NAME, "r") as f:
        assert isinstance(f.get("images", getlink=True), h5py.SoftLink)
        assert isinstance(f.get("everything", getlink=True), h5py.SoftLink)
        ic = f["instance_counts"]
        assert (ic.compression, ic.scaleoffset) == ("lzf", 0)
        # scaleoffset's 21-byte header alone outgrows the chunk
        assert 21 > ic.dtype.itemsize * np.prod(ic.chunks)
    with hdf5.File(GOLDEN / regen.DEFAULT_NAME) as f:
        assert f["instance_counts"].compression == "lzf"
        assert f["images"] is f["data/images"] is f["everything/images"]
    lst = (GOLDEN / regen.SHARED_NAMES["list"]).read_bytes()
    tree = (GOLDEN / regen.SHARED_NAMES["btree"]).read_bytes()
    assert b"SMTB" in lst and b"SMLI" in lst
    assert b"SMTB" in tree and b"SMLI" not in tree and b"BTHD" in tree


def test_golden_default_against_jax():
    """The JAX ``ClassposeHDF5Dataset`` (h5py follows the soft links) and
    the port's on the default-layout golden: counts, diameters, class
    weights and items bitwise."""
    path = str(GOLDEN / regen.DEFAULT_NAME)
    kw = dict(bsize=32, seed=3)
    a = jax_dataset.ClassposeHDF5Dataset(path, **kw)
    b = port_dataset.ClassposeHDF5Dataset(path, **kw)
    assert len(a) == len(b) == regen.N_DEFAULT
    for name in ("class_counts", "instance_counts", "diameter_array",
                 "class_weights"):
        assert bits_equal(getattr(a, name), getattr(b, name)), name
    a.augment = b.augment = False
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert bits_equal(x, y)


# -------------------------------------------------------------- soft links

def _write_links(f):
    """Soft links to a dataset and to a group, absolute and relative, at
    the root and in a subgroup; a chain, a link through a linked group,
    a link to the root, a dangling link and a cycle."""
    g = f.create_group("sub")
    g["x"] = np.arange(6.0).reshape(3, 2)
    inner = g.create_group("inner")
    inner["y"] = np.arange(5, dtype="<i2")
    f["top"] = np.arange(4, dtype=">u4")
    f["to_dataset"] = h5py.SoftLink("/sub/x")
    f["to_group"] = h5py.SoftLink("/sub")
    g["relative"] = h5py.SoftLink("x")
    g["to_inner"] = h5py.SoftLink("inner")
    inner["up_to_top"] = h5py.SoftLink("/top")
    f["chain_a"] = h5py.SoftLink("chain_b")
    f["chain_b"] = h5py.SoftLink("/to_group/inner/y")
    f["through_link"] = h5py.SoftLink("/to_group/relative")
    f["dangling"] = h5py.SoftLink("/nowhere")
    g["dangling_inner"] = h5py.SoftLink("missing")
    f["loop_a"] = h5py.SoftLink("/loop_b")
    f["loop_b"] = h5py.SoftLink("/loop_a")


@pytest.mark.parametrize("libver", [None, "latest"],
                         ids=["defaults", "latest"])
def test_soft_links(tmp_path, libver):
    """At h5py's defaults the links sit in symbol-table entries (cache
    type 2, the value in the group's local heap); under ``latest`` in
    link messages. Both read as h5py reads them; a cycle raises by name
    where h5py raises "too many links"."""
    path = tmp_path / "links.h5"
    with h5py.File(path, "w", libver=libver) as f:
        _write_links(f)
    with h5py.File(path, "r") as f:
        with pytest.raises(RuntimeError, match="too many links"):
            f["loop_a"]
    # the cycle is listed but neither side reads it
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        assert "loop_a" in ref and "loop_a" in f
        with pytest.raises(ValueError, match="too many links"):
            f["loop_a"]
    with h5py.File(path, "a") as f:
        del f["loop_a"], f["loop_b"]
    names = _same_as_h5py(path)
    assert {"to_dataset", "to_group/x", "to_group/relative",
            "to_group/inner/up_to_top", "chain_a", "through_link",
            "sub/to_inner/y"} <= set(names)
    with hdf5.File(path) as f:
        assert f["chain_a"] is f["sub/inner/y"]
        assert f.get("nowhere") is None and "nowhere" not in f


def test_soft_links_in_dataset_to_hdf5_layout(jax_file_path):
    """The JAX ``dataset_to_hdf5`` output with its arrays moved into a
    group and named again by soft links at the root (h5py's defaults):
    the same items through both packages."""
    path = jax_file_path.parent / "linked.h5"
    with h5py.File(jax_file_path, "r") as src, h5py.File(path, "w") as f:
        g = f.create_group("arrays")
        for k in src:
            g.create_dataset(k, data=src[k][()], chunks=src[k].chunks,
                             compression=src[k].compression)
            f[k] = h5py.SoftLink(f"arrays/{k}")
    _same_as_h5py(path)
    kw = dict(bsize=32, seed=3)
    a = jax_dataset.ClassposeHDF5Dataset(str(path), **kw)
    b = port_dataset.ClassposeHDF5Dataset(str(path), **kw)
    assert len(a) == len(b) == 9
    a.augment = b.augment = False
    for i in (0, 8):
        for x, y in zip(a[i], b[i]):
            assert bits_equal(x, y)


@pytest.fixture(scope="module")
def jax_file_path(tmp_path_factory):
    import argparse

    from classpose_tpu.entrypoints import dataset_to_hdf5
    from test_torch_data import disc_sample

    d = tmp_path_factory.mktemp("npy")
    data, labels = zip(*[disc_sample(i, H=32, W=32, n=3, n_classes=3)
                         for i in range(9)])
    np.save(d / "images.npy", np.stack(data))
    np.save(d / "labels.npy", np.stack(labels))
    dataset_to_hdf5.main(argparse.Namespace(
        data_path=str(d), output=str(d / "jax.h5"), min_train_masks=1))
    return d / "jax.h5"


# ---------------------------------------------------- after scaleoffset

def _spanning(rng, n: int, chunks: int, dtype: str, bits: int) -> np.ndarray:
    """``chunks`` chunks of ``n`` signed values that scaleoffset packs in
    ``bits`` bits: each chunk spans 2^bits - 1 values (its minimum and
    maximum both present; the all-ones code is the fill value's, which
    h5py leaves defined), mostly its minimum (packed as zero bits) so
    that szip compresses them and is not skipped."""
    lo = -(1 << (bits - 2))
    a = np.full((chunks, n), lo, np.int64)
    a[:, -1] = lo + (1 << bits) - 2
    a[:, n // 2] = rng.integers(lo, lo + (1 << bits) - 1, chunks)
    return a.reshape(-1).astype(dtype)


def _scaleoffset_bytes(n: int, bits: int) -> int:
    """The size of scaleoffset's output for ``n`` values of ``bits``
    bits: a 21-byte header, then the packed values and one more byte."""
    return 21 + n * bits // 8 + 1


def _aligned_bits(n: int, size: int) -> int:
    """The widest packing of ``n`` values of ``size`` bytes whose
    scaleoffset output fills whole szip pixels of ``size`` bytes."""
    return max(b for b in range(2, 8 * size - 1)
               if _scaleoffset_bytes(n, b) % size == 0)


@pytest.mark.parametrize("compression,n", [
    *[("lzf", n) for n in (8, 16, 32, 64, 128, 256, 512)],
    *[("szip", n) for n in (8, 16, 24, 40, 56, 72, 120, 248)]])
def test_after_scaleoffset(tmp_path, compression, n):
    """lzf and szip after scaleoffset at a chunk of ``n`` values, on both
    sides of the size where scaleoffset's output outgrows the chunk: lzf's
    buffer grows as h5py's does, szip takes its output size from its
    chunk.

    szip codes pixels of the type's size, and libaec leaves a last partial
    pixel unwritten when decoding: h5py then reads whatever its buffer
    held there (the port reads zeros). So the szip cases pack their
    values to fill whole pixels (:func:`_aligned_bits`), which no packing
    of a multiple of 32 values does."""
    rng = np.random.default_rng(n)
    path = tmp_path / "so.h5"
    if compression == "lzf":
        arrays = {"i2": rng.integers(0, 2 ** 15, 3 * n + 5).astype("<i2"),
                  "i4": rng.integers(-9, 9, (n + 1, 3)).astype("<i4"),
                  "i8": rng.integers(0, 2 ** 40, 2 * n).astype("<i8")}
        arrays["i8"][n // 4::2] = 0     # compressible: lzf not skipped
    else:
        # szip cannot shrink 8 values of 2 or 4 bytes, and skips them
        kinds = ("<i8",) if n == 8 else ("<i2", "<i4", "<i8")
        arrays = {k: _spanning(rng, n, 3, k, _aligned_bits(n, int(k[-1])))
                  for k in kinds}
    with h5py.File(path, "w") as f:
        for k, a in arrays.items():
            d = f.create_dataset(k, data=a, chunks=(n,) + a.shape[1:],
                                 compression=compression, scaleoffset=0)
            # a chunk went through both filters (neither skipped)
            infos = [d.id.get_chunk_info(i)
                     for i in range(d.id.get_num_chunks())]
            assert 0 in {c.filter_mask for c in infos}, k
    if compression == "szip":              # szip's size field, as predicted
        raw = path.read_bytes()
        for k, a in arrays.items():
            with h5py.File(path, "r") as f:
                c = next(c for c in map(f[k].id.get_chunk_info, range(3))
                         if c.filter_mask == 0)
            assert int.from_bytes(raw[c.byte_offset:c.byte_offset + 4],
                                  "little") == _scaleoffset_bytes(
                n, _aligned_bits(n, a.itemsize)), k
    with h5py.File(path, "r") as f:
        for k, a in arrays.items():
            assert bits_equal(f[k][()], a), k
    _same_as_h5py(path)


def test_lzf_still_refuses_corrupt_chunks(tmp_path):
    """A chunk cut short or with a back reference before its start raises
    in both readers; growing the buffer stops at corrupt data."""
    path = tmp_path / "lzf.h5"
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", data=np.tile(np.arange(64, dtype="<i4"),
                                               8), chunks=(512,),
                             compression="lzf")
        info = d.id.get_chunk_info(0)
    raw = bytearray(path.read_bytes())
    # the first byte after the opening literal run: a back reference
    # whose distance now reaches before the output's start
    at = info.byte_offset + raw[info.byte_offset] + 2
    raw[at] |= 0x1F
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as f:
        with pytest.raises(OSError):
            f["x"][()]
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="lzf chunk is corrupt"):
            np.asarray(f["x"])


# -------------------------------------------------------------------- nbit

_RNG = np.random.default_rng(7)
_INTS = [("u1", 5, 0), ("u1", 3, 4), ("i1", 6, 1), ("u2", 12, 0),
         ("u2", 9, 7), ("i2", 11, 3), ("u4", 20, 0), ("i4", 20, 4),
         ("i4", 31, 1), ("u8", 33, 17), ("i8", 40, 9), ("i8", 63, 0)]
_FLOAT_FIELDS = [
    ("f4", (31, 23, 8, 13, 10), 13, 19, None),
    ("f4", (31, 23, 8, 0, 20), 3, 29, None),
    ("f4", (26, 20, 6, 7, 13), 7, 20, 31),
    ("f4", (15, 10, 5, 0, 10), 0, 16, 15),
    ("f8", (63, 52, 11, 32, 20), 32, 32, None),
    ("f8", (63, 52, 11, 0, 30), 22, 42, None),
    ("f8", (40, 30, 10, 3, 27), 3, 38, 511),
    ("f2", (15, 10, 5, 4, 6), 4, 12, None),
]


def _int_case(kind, precision, offset, order):
    base = getattr(h5py.h5t, f"STD_{kind[0].upper()}{8 * int(kind[1])}"
                   f"{'BE' if order == '>' else 'LE'}")
    tid = regen.nbit_type(base, precision, offset)
    info = np.iinfo(kind)
    # values past the precision too: libhdf5 saturates them on writing
    a = _RNG.integers(info.min // 2, info.max // 2, (24, 3),
                      dtype=np.int64 if kind[0] == "i" else np.uint64)
    return tid, a.astype(order + kind)


def _float_case(kind, fields, offset, precision, ebias, order):
    base = getattr(h5py.h5t, f"IEEE_F{8 * int(kind[1])}"
                   f"{'BE' if order == '>' else 'LE'}")
    tid = regen.nbit_type(base, precision, offset, fields, ebias)
    a = regen._float_values(_RNG, 72, order + kind).reshape(24, 3)
    return tid, a


_NBIT = {f"{kind}{'be' if o == '>' else ''}_{p}_{off}":
         (_int_case, (kind, p, off, o))
         for kind, p, off in _INTS for o in "<>"}
_NBIT.update({f"{kind}{'be' if o == '>' else ''}_fields_{'_'.join(map(str, f))}":
              (_float_case, (kind, f, off, p, eb, o))
              for kind, f, off, p, eb in _FLOAT_FIELDS for o in "<>"})


@pytest.mark.parametrize("case", list(_NBIT))
def test_nbit_reduced_precision(tmp_path, case):
    """The nbit filter over an integer or float type whose precision is
    below its size (at an offset, floats with narrower fields): the
    packed bits unpacked, then converted to the dtype h5py gives (an
    integer's field sign-extended; a float's value exactly, infinities
    and NaN as libhdf5 converts them), chunked and unchunked."""
    make, args = _NBIT[case]
    tid, a = make(*args)
    path = tmp_path / "nbit.h5"
    with h5py.File(path, "w") as f:
        regen.nbit_dataset(f, "x", tid, a, (5, 3))
        regen.nbit_dataset(f, "whole", tid, a, a.shape)
        cd = f["x"].id.get_create_plist().get_filter(0)[2]
        assert cd[1] == 0 and cd[3] == 1       # packed, an atomic type
        # the same type unfiltered and contiguous: the conversion alone
        h5py.h5d.create(f.id, b"plain", tid,
                        h5py.h5s.create_simple(a.shape)).write(
            h5py.h5s.ALL, h5py.h5s.ALL, a)
    _same_as_h5py(path)


# --------------------------------------------------------- shared messages

@pytest.mark.parametrize("index", ["list", "btree"])
@pytest.mark.parametrize("libver", [None, "latest"],
                         ids=["defaults", "latest"])
@pytest.mark.parametrize("min_size", [0, 24])
def test_shared_messages(tmp_path, index, libver, min_size):
    """Shared object header messages: dataspace, datatype, fill value and
    filter pipeline messages in the shared message heap, referenced from
    version 1 or 2 headers; at a minimum size some stay unshared. More
    than 50 messages move a list index to a B-tree."""
    path = tmp_path / "s.h5"
    rng = np.random.default_rng(min_size)
    with regen.shared_file(path, index, min_size=min_size,
                           libver=libver) as f:
        for i in range(60 if index == "list" else 6):
            shape = (i % 4 + 1, 3)
            f.create_dataset(f"d{i:02d}", data=rng.normal(0, 9, shape).astype(
                ("<f4", ">i4", "<u2")[i % 3]), chunks=(1, 3),
                compression="gzip" if i % 2 else "lzf", fillvalue=i % 5)
        f.create_dataset("contiguous", data=np.arange(7.0))
        f["linked"] = h5py.SoftLink("/d03")
    raw = path.read_bytes()
    assert b"SMTB" in raw and b"FRHP" in raw
    _same_as_h5py(path)


# ----------------------------------------------------------------- refusals

def _nbit_compound(f):
    dt = np.dtype([("a", "<i2"), ("b", "<f4")])
    tid = h5py.h5t.py_create(dt)
    regen.nbit_dataset(f, "x", tid, np.zeros(8, dt), (4,))


def _nbit_array(f):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((4,))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    h5py.h5d.create(f.id, b"x", h5py.h5t.array_create(h5py.h5t.STD_I16LE,
                                                      (2,)),
                    h5py.h5s.create_simple((8,)), dcpl=dcpl)


def _float128(f):
    tid = regen.nbit_type(h5py.h5t.IEEE_F64LE, 64, 0, ebias=1000)
    assert tid.dtype.itemsize == 16
    h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple((3,)))


def _float_of_6_bytes(f):
    """A float whose offset grew its size (HDF5 widens the type to hold
    offset + precision): h5py reads it as float64."""
    t = h5py.h5t.IEEE_F32LE.copy()
    t.set_fields(31, 23, 8, 13, 10)
    t.set_offset(13)
    assert t.get_size() == 6 and t.dtype == np.float64
    h5py.h5d.create(f.id, b"x", t, h5py.h5s.create_simple((3,)))


@pytest.mark.parametrize("write,match", [
    (_nbit_compound, "compound datatypes"),
    (_nbit_array, "array datatypes"),
    (_float128, "wider than float64"),
    (_float_of_6_bytes, "floating point of 6 bytes"),
], ids=["nbit_compound", "nbit_array", "float128", "float_6_bytes"])
def test_refuses(tmp_path, write, match):
    path = tmp_path / "r.h5"
    with h5py.File(path, "w") as f:
        write(f)
    with pytest.raises(ValueError, match=match):
        with hdf5.File(path) as f:
            np.asarray(f["x"])
