"""The port's HDF5 reader and writer (``classpose_tpu_torch/io/hdf5.py``)
against h5py, and its ``ClassposeHDF5Dataset`` against the JAX
package's, on the CPU.

- the reader on files h5py writes at its defaults: the JAX
  ``dataset_to_hdf5`` output (70 samples: a two-level chunk B-tree),
  chunked with gzip and without a filter, contiguous, edge chunks, more
  than 64 and more than 4096 chunks, f4, f8, i8, u1 and more; every
  array bitwise, whole and by rows;
- the writer's files read by h5py bitwise, chunked and contiguous, at
  the same shapes;
- each refused feature raises a ``ValueError`` that names it;
- the dataset: length, cached counts and diameters, ``subset``, items
  without augmentation, items through pipelines seeded alike (the random
  rotate/resize replaced by the same crop in both packages: the port's
  scipy warp agrees with cv2's only to its 1/32-pixel grid, see
  ``tests/test_torch_data.py``), and pickling."""

import argparse
import hashlib
import json
import pickle
from pathlib import Path

import h5py
import numpy as np
import pytest

import classpose_tpu.train.dataset as jax_dataset
import classpose_tpu.transforms as jt
import classpose_tpu_torch.train.dataset as port_dataset
import classpose_tpu_torch.transforms as pt
from classpose_tpu.entrypoints import dataset_to_hdf5 as jax_to_hdf5
from classpose_tpu_torch.io import hdf5

from test_torch_data import disc_sample


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """The JAX ``dataset_to_hdf5`` on 70 disc images of 40²: 70 chunks
    per array, so its chunk B-trees have two levels."""
    d = tmp_path_factory.mktemp("npy")
    data, labels = zip(*[disc_sample(i, H=40, W=40, n=4, n_classes=3)
                         for i in range(70)])
    np.save(d / "images.npy", np.stack(data))
    np.save(d / "labels.npy", np.stack(labels))
    out = d / "jax.h5"
    jax_to_hdf5.main(argparse.Namespace(data_path=str(d), output=str(out),
                                        min_train_masks=1))
    return out


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "gzip": (rng.random((9, 3, 5, 7)).astype(np.float32),
                 dict(chunks=(1, 3, 5, 7), compression="gzip",
                      compression_opts=2)),
        "plain_chunks": (rng.integers(-9, 9, (70, 3)).astype(np.int64),
                         dict(chunks=(1, 3))),
        "edges": (rng.random((13, 7, 9)),
                  dict(chunks=(4, 3, 4), compression="gzip")),
        "many": (rng.random((4500, 2)).astype(np.float32),
                 dict(chunks=(1, 2), compression="gzip",
                      compression_opts=2)),
        "f4": (rng.random((6, 4)).astype(np.float32), {}),
        "f8": (rng.random(7), {}),
        "i8": (np.arange(-5, 5, dtype=np.int64), {}),
        "u1": (rng.integers(0, 256, (5, 4)).astype(np.uint8), {}),
        "i2": (rng.integers(-300, 300, (3, 3)).astype(np.int16), {}),
        "u4": (rng.integers(0, 2**31, 4).astype(np.uint32), {}),
        "empty": (np.zeros((0, 3), np.float32), {}),
    }


def _check_read(f, name, ref):
    ds = f[name]
    assert ds.shape == ref.shape and ds.dtype == ref.dtype
    assert bits_equal(np.asarray(ds), ref)
    if len(ref):
        for sl in (slice(0, 1), slice(2, 11), slice(-3, None)):
            assert bits_equal(ds[sl], ref[sl]), (name, sl)
        assert bits_equal(ds[len(ref) - 1], ref[-1])
        assert bits_equal(ds[-1], ref[-1])


def test_reads_jax_dataset_to_hdf5(jax_file):
    with h5py.File(jax_file, "r") as ref, hdf5.File(jax_file) as f:
        assert set(f) == set(ref) == {"images", "labels", "class_counts",
                                      "instance_counts", "diameters"}
        assert f["images"].chunks == ref["images"].chunks == (1, 3, 40, 40)
        assert f["labels"].compression == "gzip"
        assert len(f["labels"]) == 70
        for name in ref:
            _check_read(f, name, ref[name][()])


def test_reads_what_h5py_writes(tmp_path):
    path = tmp_path / "h5py.h5"
    arrays = _arrays()
    with h5py.File(path, "w") as f:
        for name, (a, kw) in arrays.items():
            f.create_dataset(name, data=a, **kw)
        g = f.create_group("group")
        g.create_dataset("inner", data=np.arange(3.0))
        f["f4"].attrs["note"] = "attributes are skipped"
    with hdf5.File(path) as f:
        for name, (a, _) in arrays.items():
            _check_read(f, name, a)
        assert bits_equal(f["group/inner"], np.arange(3.0))
        assert f["many"].chunks == (1, 2) and f["f8"].chunks is None


def test_reads_compact_layout(tmp_path):
    path = tmp_path / "compact.h5"
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(a.shape)
        h5py.h5d.create(f.id, b"c", h5py.h5t.IEEE_F32LE, space,
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, a)
    with hdf5.File(path) as f:
        _check_read(f, "c", a)


def test_h5py_reads_what_the_writer_writes(tmp_path):
    """Chunked (gzip and unfiltered, edge chunks, 4500 chunks: a
    three-level B-tree) and contiguous arrays, more names than one symbol
    table node holds."""
    path = tmp_path / "port.h5"
    arrays = _arrays()
    with hdf5.Writer(path) as f:
        for name, (a, kw) in arrays.items():
            f.create_dataset(name, data=a, **kw)
    with h5py.File(path, "r") as f:
        assert set(f) == set(arrays)
        for name, (a, kw) in arrays.items():
            assert f[name].dtype == a.dtype and f[name].shape == a.shape
            assert bits_equal(f[name][()], a), name
            assert f[name].chunks == kw.get("chunks")
            assert f[name].compression == kw.get("compression")
        assert f["gzip"].compression_opts == 2
    with hdf5.File(path) as f:
        for name, (a, _) in arrays.items():
            _check_read(f, name, a)


def test_writer_refuses(tmp_path):
    with hdf5.Writer(tmp_path / "w.h5") as f:
        with pytest.raises(ValueError, match="gzip only"):
            f.create_dataset("x", data=np.zeros(3), compression="lzf")
        with pytest.raises(ValueError, match="not supported"):
            f.create_dataset("s", data=np.array(["a"]))
        with pytest.raises(ValueError, match="root only"):
            f.create_dataset("g/x", data=np.zeros(3))
        f.create_dataset("x", data=np.zeros(3))
        with pytest.raises(ValueError, match="root only"):
            f.create_dataset("x", data=np.zeros(3))


def _write_big_endian(f):
    f.create_dataset("x", data=np.arange(4, dtype=">f4"))


def _write_dense_links(f):
    for i in range(12):
        f.create_dataset(f"x{i}", data=np.arange(i + 1))


def _all_datasets(path):
    """Every dataset name h5py sees, soft links included."""
    names = []
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                names.append(name)
        f.visititems(visit)
        for k in f:
            if isinstance(f.get(k, getlink=True), h5py.SoftLink):
                names.append(k)
    return names


def _reads_as_h5py(path, names=None):
    """Every dataset read by the port equals h5py's (dtype with its byte
    order, shape, bytes) through ``ds[()]``, ``np.asarray``, rows and row
    ranges."""
    names = names or _all_datasets(path)
    assert names
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        for name in names:
            want = ref[name][()]
            assert bits_equal(f[name][()], want), name
            assert bits_equal(np.asarray(f[name]), np.asarray(ref[name])), \
                name
            assert f[name].shape == ref[name].shape
            if want.ndim and len(want) > 2:
                assert bits_equal(f[name][1:3], ref[name][1:3]), name
                assert bits_equal(f[name][-1], ref[name][-1]), name
    return names


@pytest.mark.parametrize("feature,write,kw", [
    ("latest", lambda f: f.create_dataset("x", data=np.arange(4)),
     dict(libver="latest")),
    ("v2_headers", lambda f: f.create_dataset("x", data=np.arange(4)),
     dict(track_order=True)),
    ("shuffle", lambda f: f.create_dataset(
        "x", data=np.ones((4, 10)), chunks=(1, 10), shuffle=True,
        compression="gzip"), {}),
    ("fletcher32", lambda f: f.create_dataset(
        "x", data=np.ones((4, 10)), chunks=(1, 10), fletcher32=True), {}),
    ("big_endian", _write_big_endian, {}),
    ("scalar", lambda f: f.create_dataset("x", data=1.5), {}),
    ("dense_links", _write_dense_links, dict(libver="latest")),
])
def test_reader_reads_past_defaults(tmp_path, feature, write, kw):
    """What the reader refused before it read h5py's files past their
    defaults, read as h5py reads it."""
    path = tmp_path / f"{feature}.h5"
    with h5py.File(path, "w", **kw) as f:
        write(f)
    _reads_as_h5py(path)


def _write_vds_irregular(f):
    """HDF5 takes no point selection in a virtual mapping; an index list
    that no regular hyperslab covers is the irregular kind."""
    f["src"] = np.arange(6.0)
    layout = h5py.VirtualLayout(shape=(4,), dtype="f8")
    layout[[0, 1, 3]] = h5py.VirtualSource(".", "src", shape=(6,))[[0, 2, 5]]
    f.create_virtual_dataset("x", layout)


def _write_null(f):
    f.create_dataset("x", data=h5py.Empty("f4"))


@pytest.mark.parametrize("feature,write,kw,match", [
    ("compound", lambda f: f.create_dataset(
        "x", data=np.zeros(3, dtype=[("a", "<f4"), ("b", "<i4")])), {},
     "compound datatypes"),
    ("vlen", lambda f: f.create_dataset(
        "x", data=["ab", "c"], dtype=h5py.string_dtype()), {},
     "variable-length datatypes"),
    ("null", _write_null, {}, "null dataspaces"),
    ("string", lambda f: f.create_dataset("x", data=np.array([b"ab"])), {},
     "string datatypes"),
    ("external_link", lambda f: f.__setitem__(
        "x", h5py.ExternalLink("other.h5", "/y")), dict(libver="latest"),
     "external links"),
    ("vds_irregular", _write_vds_irregular, dict(libver="latest"),
     "other than regular hyperslabs"),
])
def test_reader_refuses(tmp_path, feature, write, kw, match):
    path = tmp_path / f"{feature}.h5"
    with h5py.File(path, "w", **kw) as f:
        write(f)
    with pytest.raises(ValueError, match=match):
        with hdf5.File(path) as f:
            np.asarray(f["x"])


# ------------------------------------------- past h5py's defaults (B1-B7)

def test_latest_structure(tmp_path):
    """Superblock 3 (checksum checked), version 2 headers with their
    continuation blocks, compact and dense links (3000 names: a fractal
    heap with indirect blocks, a v2 B-tree of depth > 0), soft links to a
    dataset and to a group, creation order tracked."""
    path = tmp_path / "latest.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", libver="latest") as f:
        f["a"] = rng.random(5)
        g = f.create_group("many")
        for i in range(3000):
            g.create_dataset(f"n{i:05d}_{'x' * (i % 37)}", data=[i])
        t = f.create_group("ordered", track_order=True)
        for i in range(20):
            t.create_dataset(f"o{i}", data=np.full(2, i, "u2"))
        f["soft"] = h5py.SoftLink("/a")
        f["soft_group"] = h5py.SoftLink("ordered")
        f["a"].attrs["note"] = "x" * 10000   # a continuation block
    names = _reads_as_h5py(path, ["a", "soft", "soft_group/o7",
                                  "many/n02999_" + "x" * (2999 % 37),
                                  "ordered/o19"])
    with hdf5.File(path) as f:
        assert len([k for k in f if k.startswith("many/")]) == 3000
        assert "soft_group/o0" in f and names
    raw = bytearray(path.read_bytes())
    raw[28] ^= 1                              # the end-of-file address
    bad = tmp_path / "bad.h5"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="superblock: checksum"):
        hdf5.File(bad)


@pytest.mark.parametrize("index", ["single", "single_filtered", "implicit",
                                   "fixed", "fixed_paged", "extensible",
                                   "extensible_grown", "btree2",
                                   "btree2_filtered", "contiguous",
                                   "compact"])
def test_chunk_indexes(tmp_path, index):
    """Layout version 4: each chunk index h5py writes under
    libver="latest", and contiguous and compact storage."""
    path = tmp_path / f"{index}.h5"
    rng = np.random.default_rng(1)
    a = rng.random((9, 10))
    with h5py.File(path, "w", libver="latest") as f:
        if index == "single":
            f.create_dataset("x", data=a, chunks=a.shape)
        elif index == "single_filtered":
            f.create_dataset("x", data=a, chunks=a.shape, compression="gzip")
        elif index == "implicit":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((2, 3))
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F64LE,
                            h5py.h5s.create_simple(a.shape), dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, a)
        elif index == "fixed":
            f.create_dataset("x", data=a, chunks=(2, 3), compression="gzip")
        elif index == "fixed_paged":         # past 1024 chunks: pages
            b = rng.integers(0, 99, (2100, 3))
            d = f.create_dataset("x", shape=b.shape, chunks=(1, 3),
                                 dtype="i8")
            d[:1500] = b[:1500]              # later pages uninitialized
        elif index == "extensible":
            f.create_dataset("x", data=a, chunks=(2, 3),
                             maxshape=(None, 10), compression="lzf")
        elif index == "extensible_grown":    # past the index block and
            d = f.create_dataset("x", shape=(3, 4), chunks=(1, 4),  # its
                                 maxshape=(None, 4), dtype="i4")    # data
            d[:] = 7                                                # blocks
            d.resize((700, 4))
            d[400:] = rng.integers(0, 9, (300, 4))
        elif index == "btree2":
            f.create_dataset("x", data=a, chunks=(2, 3),
                             maxshape=(None, None))
        elif index == "btree2_filtered":
            f.create_dataset("x", data=a, chunks=(2, 3),
                             maxshape=(None, None), compression="gzip",
                             shuffle=True)
        elif index == "contiguous":
            f.create_dataset("x", data=a)
        else:
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F64LE,
                            h5py.h5s.create_simple(a.shape), dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, a)
    _reads_as_h5py(path)


@pytest.mark.parametrize("pipeline", [
    dict(shuffle=True, compression="gzip"),
    dict(fletcher32=True),
    dict(shuffle=True, compression="gzip", fletcher32=True),
    dict(compression="lzf"),
    dict(compression="lzf", shuffle=True),
    dict(compression="szip"),
    dict(compression="szip", compression_opts=("ec", 16)),
    dict(scaleoffset=0),
    dict(scaleoffset=2),
], ids=["shuffle", "fletcher32", "shuffle_gzip_fletcher32", "lzf",
        "lzf_shuffle", "szip_nn", "szip_ec", "scaleoffset_int",
        "scaleoffset_float"])
def test_filters(tmp_path, pipeline):
    """Each filter h5py writes, in pipeline order, on the dtypes it takes
    (edge chunks, a chunk of constant values, an incompressible chunk that
    lzf stores unfiltered); the properties h5py reports."""
    path = tmp_path / "f.h5"
    rng = np.random.default_rng(2)
    arrays = {
        "f4": rng.normal(0, 30, (13, 37)).astype("<f4"),
        "f8": rng.normal(0, 30, (13, 37)),
        "i8": rng.integers(-100, 4000, (13, 37)),
        "i2": rng.integers(-300, 300, (13, 37)).astype("i2"),
        "u2": rng.integers(0, 60000, (13, 37)).astype("u2"),
        "be": rng.normal(0, 3, (13, 37)).astype(">f4"),
        "const": np.full((13, 37), 7, "i4"),
    }
    with h5py.File(path, "w") as f:
        for name, a in arrays.items():
            if "scaleoffset" in pipeline and (
                    (pipeline["scaleoffset"] == 0) != (a.dtype.kind in "iu")
                    or name == "u2"):    # h5py cannot read it back
                continue
            f.create_dataset(name, data=a, chunks=(4, 37), **pipeline)
    names = _reads_as_h5py(path)
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        for name in names:
            for prop in ("compression", "compression_opts", "shuffle",
                         "fletcher32", "scaleoffset", "chunks"):
                assert getattr(f[name], prop) == getattr(ref[name], prop), \
                    (name, prop)


def test_fletcher32_mismatch_raises_as_h5py(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(40.0).reshape(4, 10),
                         chunks=(1, 10), fletcher32=True)
        offset = f["x"].id.get_chunk_info(2).byte_offset
    raw = bytearray(path.read_bytes())
    raw[offset + 3] ^= 0x10
    path.write_bytes(bytes(raw))
    with h5py.File(path, "r") as f:
        with pytest.raises(OSError):
            f["x"][()]
        assert bits_equal(f["x"][:2], np.arange(20.0).reshape(2, 10))
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="Fletcher32"):
            np.asarray(f["x"])
        assert bits_equal(f["x"][:2], np.arange(20.0).reshape(2, 10))


def test_datatypes(tmp_path):
    """Big-endian integers and floats (returned as the same ">" dtypes
    h5py returns), float16, h5py's bool, an integer enum (its base type),
    a committed datatype, under both header versions."""
    rng = np.random.default_rng(3)
    for kw in ({}, dict(libver="latest")):
        path = tmp_path / f"t{len(kw)}.h5"
        with h5py.File(path, "w", **kw) as f:
            for dt in (">i2", ">u4", ">i8", ">f4", ">f8", "<f2", ">f2"):
                f.create_dataset(dt, data=(rng.normal(0, 50, 7)).astype(dt))
            f.create_dataset("bool", data=rng.random(11) > 0.5)
            f.create_dataset("enum", data=np.array([0, 2, 1, 2], "i2"),
                             dtype=h5py.enum_dtype({"a": 0, "b": 1, "c": 2},
                                                   basetype="i2"))
            f["t"] = np.dtype(">f4")
            f.create_dataset("committed", data=np.arange(3, dtype=">f4"),
                             dtype=f["t"])
            f.create_dataset("bool_chunked", data=rng.random((5, 3)) > 0.5,
                             chunks=(2, 3), compression="gzip")
        names = _reads_as_h5py(path)
        assert {">i2", "bool", "enum", "committed"} <= set(names)


def test_scalar_datasets(tmp_path):
    path = tmp_path / "s.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("f", data=2.5)
        f.create_dataset("i", data=np.int16(-3))
        f.create_dataset("be", data=np.array(7, ">u8"))
    _reads_as_h5py(path)
    with hdf5.File(path) as f:
        assert f["f"].shape == () and f["f"][()] == 2.5
        assert np.asarray(f["i"]).shape == ()
        with pytest.raises(TypeError):
            len(f["f"])


def test_external_storage(tmp_path, monkeypatch):
    """Message type 7: the slots' names, offsets and sizes; a relative
    name is opened from the working directory, as h5py 3.14 / HDF5 1.14
    open it (both fail from another one)."""
    a = np.arange(20, dtype="<f4")
    (tmp_path / "one.bin").write_bytes(a[:8].tobytes())
    (tmp_path / "two.bin").write_bytes(b"xx" + a[8:].tobytes())
    path = tmp_path / "e.h5"
    monkeypatch.chdir(tmp_path)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", shape=(20,), dtype="<f4",
                         external=[("one.bin", 0, 32), ("two.bin", 2, 48)])
        f.create_dataset("y", shape=(5,), dtype="<i8",
                         external=[(str(tmp_path / "abs.bin"), 0, 40)])
    (tmp_path / "abs.bin").write_bytes(np.arange(5).tobytes())
    _reads_as_h5py(path)
    other = tmp_path / "elsewhere"
    other.mkdir()
    monkeypatch.chdir(other)
    with h5py.File(path, "r") as f:
        with pytest.raises(OSError):
            f["x"][()]
        assert bits_equal(f["y"][()], np.arange(5))
    with hdf5.File(path) as f:
        with pytest.raises(OSError):
            np.asarray(f["x"])
        assert bits_equal(f["y"][()], np.arange(5))


def _nbit_file(path, dtype, a):
    """h5py's nbit filter on a full-precision type: cd_values[1] = 1,
    "need not compress"."""
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4,) + a.shape[1:])
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        h5py.h5d.create(f.id, b"x", dtype, h5py.h5s.create_simple(a.shape),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, a)
        return f["x"].id.get_create_plist().get_filter(0)[2]


@pytest.mark.parametrize("dtype,np_dtype", [
    (h5py.h5t.STD_I16LE, "<i2"), (h5py.h5t.IEEE_F32LE, "<f4"),
    (h5py.h5t.STD_U8LE, "u1"), (h5py.h5t.IEEE_F64BE, ">f8")],
    ids=["i2", "f4", "u1", "f8_big_endian"])
def test_nbit_full_precision(tmp_path, dtype, np_dtype):
    """The nbit filter as h5py writes it passes the chunk bytes through;
    the same file with the "need not compress" flag cleared reads as
    h5py reads it: the chunk taken as full-precision values packed MSB
    first (a little-endian type of several bytes comes back with its
    bytes swapped)."""
    path = tmp_path / "nbit.h5"
    a = (np.random.default_rng(4).normal(0, 50, (11, 3)) + 60
         ).astype(np_dtype)
    cd = _nbit_file(path, dtype, a)
    assert cd[0] == 8 and cd[1] == 1
    _reads_as_h5py(path)
    raw = path.read_bytes()
    packed = np.array(cd, "<u4").tobytes()
    assert raw.count(packed) == 1
    at = raw.index(packed) + 4
    path.write_bytes(raw[:at] + b"\0\0\0\0" + raw[at + 4:])
    _reads_as_h5py(path)
    with h5py.File(path, "r") as f:
        assert bits_equal(f["x"][()],
                          a.byteswap() if np_dtype[0] == "<" else a)


def _external_pair(tmp_path, where):
    """A parent ``p.h5`` in ``tmp_path/sub`` whose "x" is an external link
    to ``t.h5:/d``; ``where`` says which copies of ``t.h5`` exist (each
    holds a different array)."""
    sub = tmp_path / "sub"
    sub.mkdir()
    copies = {"beside": sub / "t.h5", "cwd": tmp_path / "t.h5",
              "absolute": tmp_path / "abs" / "t.h5"}
    for i, (key, path) in enumerate(copies.items()):
        if key in where:
            path.parent.mkdir(exist_ok=True)
            with h5py.File(path, "w") as f:
                f["d"] = np.arange(3 + i, dtype="<i4") * (i + 1)
                f.create_group("g")["e"] = np.full(2, i, "u2")
    target = str(copies["absolute"]) if "absolute" in where else "t.h5"
    with h5py.File(sub / "p.h5", "w") as f:
        f["x"] = h5py.ExternalLink(target, "/d")
        f["grp"] = h5py.ExternalLink(target, "/g")
        f["own"] = np.arange(4.0)
    return sub / "p.h5"


@pytest.mark.parametrize("where", [("beside",), ("cwd",), ("beside", "cwd"),
                                   ("absolute",), ("absolute", "beside")],
                         ids=["beside", "cwd", "both", "absolute",
                              "absolute_gone_beside"])
def test_external_links(tmp_path, monkeypatch, where):
    """h5py's ExternalLink, to a dataset and into a group, its target found
    as HDF5 1.14 finds it: an absolute name as is, else beside the parent
    file, then from the working directory (with both present, the copy
    beside the parent, as h5py reads it)."""
    path = _external_pair(tmp_path, where)
    if where == ("absolute", "beside"):    # the absolute copy is gone
        (tmp_path / "abs" / "t.h5").unlink()
    monkeypatch.chdir(tmp_path)
    _reads_as_h5py(path, ["x", "grp/e", "own"])
    with hdf5.File(path) as f:
        assert {"x", "grp", "own"} <= set(f) and "grp/e" in f


def test_external_link_chains_and_faults(tmp_path, monkeypatch):
    """A chain of links across three files reads as h5py reads it; a
    missing file or object raises by name when read (the file opens and
    its other names read); a cycle stops at HDF5's limit of 16 links."""
    monkeypatch.chdir(tmp_path)
    with h5py.File("c.h5", "w") as f:
        f["d"] = np.arange(6, dtype="<f8").reshape(2, 3)
    with h5py.File("b.h5", "w") as f:
        f["hop"] = h5py.ExternalLink("c.h5", "/d")
        f["loop"] = h5py.ExternalLink("a.h5", "/loop")
    with h5py.File("a.h5", "w", libver="latest") as f:
        f["chain"] = h5py.ExternalLink("b.h5", "/hop")
        f["loop"] = h5py.ExternalLink("b.h5", "/loop")
        f["gone"] = h5py.ExternalLink("missing.h5", "/d")
        f["nopath"] = h5py.ExternalLink("c.h5", "/nope")
        f["ok"] = np.arange(3)
    _reads_as_h5py("a.h5", ["chain", "ok"])
    with h5py.File("a.h5", "r") as ref, hdf5.File("a.h5") as f:
        for name, match in (("gone", "missing.h5"), ("nopath", "nope"),
                            ("loop", "too many links")):
            with pytest.raises(KeyError):
                ref[name]
            with pytest.raises(ValueError, match=match):
                f[name]
        assert bits_equal(f["ok"][()], ref["ok"][()])


def test_external_link_dataset_against_jax(jax_file, tmp_path):
    """The JAX ``ClassposeHDF5Dataset`` (h5py follows the links) and the
    port's on a file whose arrays are all external links into the JAX
    ``dataset_to_hdf5`` output: the same counts and items."""
    path = tmp_path / "links.h5"
    with h5py.File(jax_file, "r") as f:
        names = list(f)
    with h5py.File(path, "w") as f:
        for name in names:
            f[name] = h5py.ExternalLink(str(jax_file), "/" + name)
    kw = dict(bsize=32, seed=3)
    a = jax_dataset.ClassposeHDF5Dataset(str(path), **kw)
    b = port_dataset.ClassposeHDF5Dataset(str(path), **kw)
    assert len(a) == len(b) == 70
    for name in ("class_counts", "instance_counts", "diameter_array",
                 "class_weights"):
        assert bits_equal(getattr(a, name), getattr(b, name)), name
    a.augment = b.augment = False
    for i in (0, 9, 69):
        for x, y in zip(a[i], b[i]):
            assert bits_equal(x, y)


def test_virtual_datasets(tmp_path, monkeypatch):
    """Sources in the same file (".") and in another file by a relative
    path (found next to the virtual file, from any working directory),
    "all" and regular hyperslab selections (strided and blocked), the
    fill value where nothing maps or a source is missing."""
    with h5py.File(tmp_path / "src.h5", "w") as f:
        f["a"] = np.arange(12.0).reshape(3, 4)
    path = tmp_path / "v.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["b"] = np.arange(12.0, 24.0).reshape(3, 4)
        layout = h5py.VirtualLayout(shape=(4, 3, 4), dtype="f8")
        layout[0] = h5py.VirtualSource("src.h5", "a", shape=(3, 4))
        layout[1, :2] = h5py.VirtualSource(".", "b", shape=(3, 4))[1:3]
        layout[2, ::2, 1:3] = h5py.VirtualSource(
            "src.h5", "a", shape=(3, 4))[0:2, 2:4]
        layout[3, 1] = h5py.VirtualSource("missing.h5", "a",
                                          shape=(3, 4))[0]
        f.create_virtual_dataset("v", layout, fillvalue=-1)
    monkeypatch.chdir(tmp_path.parent)
    _reads_as_h5py(path, ["v", "b"])


# ------------------------------------------------------------- the golden

GOLDEN = Path(__file__).parent / "golden"


def test_golden_latest_file():
    """``tests/golden/hdf5_latest.h5`` (``regenerate_hdf5.py``): h5py and
    the port read every dataset to the recorded digest."""
    spec = json.loads((GOLDEN / "hdf5_golden.json").read_text())
    path = GOLDEN / spec["file"]
    assert path.stat().st_size <= 512 * 1024
    names = _reads_as_h5py(path, sorted(spec["datasets"]))
    with hdf5.File(path) as f:
        assert set(f) == set(spec["datasets"]) == set(names)
        for name, want in spec["datasets"].items():
            a = np.asarray(f[name][()])
            assert a.dtype.str == want["dtype"] and \
                list(a.shape) == want["shape"], name
            assert hashlib.sha256(a.tobytes()).hexdigest() == \
                want["sha256"], name
        assert f["images"].fletcher32 and f["images"].shuffle
        assert f["labels"].compression == "lzf"
        assert f["instance_counts"].compression == "szip"


def test_golden_dataset_against_jax():
    """The JAX ``ClassposeHDF5Dataset`` (h5py) and the port's on the
    golden: counts, diameters (big-endian as stored) and items bitwise."""
    path = str(GOLDEN / "hdf5_latest.h5")
    kw = dict(bsize=32, seed=3)
    a = jax_dataset.ClassposeHDF5Dataset(path, **kw)
    b = port_dataset.ClassposeHDF5Dataset(path, **kw)
    assert len(a) == len(b) == 8
    for name in ("class_counts", "instance_counts", "diameter_array",
                 "class_weights"):
        assert bits_equal(getattr(a, name), getattr(b, name)), name
    a.augment = b.augment = False
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert bits_equal(x, y)


# ----------------------------------------------------------------- dataset

def _crop(img, lbl, rescale=1.0, scale_range=0.5, xy=(32, 32), rng=None):
    """The same deterministic stand-in for the random rotate/resize in
    both packages: a top-left crop (and one draw, as the warp draws)."""
    rng.uniform(0, 1)
    return (np.ascontiguousarray(img[:, :xy[0], :xy[1]]),
            np.ascontiguousarray(lbl[:, :xy[0], :xy[1]]), 1.0)


def test_dataset_against_jax(jax_file, monkeypatch):
    kw = dict(bsize=32, seed=3)
    a = jax_dataset.ClassposeHDF5Dataset(str(jax_file), **kw)
    b = port_dataset.ClassposeHDF5Dataset(str(jax_file), **kw)
    assert len(a) == len(b) == 70
    assert bits_equal(a.class_counts, b.class_counts)
    assert bits_equal(a.instance_counts, b.instance_counts)
    assert bits_equal(a.diameter_array, b.diameter_array)
    assert a.n_classes == b.n_classes == 3
    assert bits_equal(a.class_weights, b.class_weights)

    idx = [0, 5, 64, 69, 33]
    sa, sb = a.subset(idx), b.subset(idx)
    assert len(sa) == len(sb) == 5
    assert bits_equal(sa.indices, sb.indices)
    assert bits_equal(sa.diameter_array, sb.diameter_array)
    assert bits_equal(sa.class_counts, sb.class_counts)
    assert bits_equal(sa.instance_counts, sb.instance_counts)
    with pytest.raises(ValueError):
        b.subset([])
    with pytest.raises(IndexError):
        b.subset([70])

    for ds in (sa, sb):
        ds.augment = False
    for i in range(len(sb)):
        for x, y in zip(sa[i], sb[i]):
            assert bits_equal(x, y)

    # both pipelines replaced by ones seeded alike, the warp by one crop
    monkeypatch.setattr(jax_dataset, "random_rotate_and_resize", _crop)
    monkeypatch.setattr(port_dataset, "random_rotate_and_resize", _crop)
    ka = jax_dataset.ClassposeHDF5Dataset(str(jax_file), keep_open=True,
                                          **kw)
    kb = port_dataset.ClassposeHDF5Dataset(str(jax_file), keep_open=True,
                                           **kw)
    ka.augment_pipeline = jt.StarDistAugmentation("enhanced", seed=5)
    kb.augment_pipeline = pt.StarDistAugmentation("enhanced", seed=5)
    for i in (0, 7, 65, 7):
        for x, y in zip(ka[i], kb[i]):
            assert bits_equal(x, y)

    # pickling drops the open handle; the copy reads the same items
    assert kb._fh is not None
    kb2 = pickle.loads(pickle.dumps(kb))
    assert kb2._fh is None and kb._fh is not None
    kb.augment = kb2.augment = False
    for x, y in zip(kb[3], kb2[3]):
        assert bits_equal(x, y)


def test_dataset_builds_the_named_pipeline(jax_file):
    ds = port_dataset.ClassposeHDF5Dataset(
        str(jax_file), augmentation_strategy="hed_only", bsize=32)
    assert isinstance(ds.augment_pipeline, pt.StarDistAugmentation)
    assert ds.augment_pipeline.hed_p == 1.0 and ds.augment_pipeline.he_p == 0
    x, y = ds[0]
    assert x.shape == (3, 32, 32) and y.shape == (4, 32, 32)
    assert np.isfinite(x).all()
    with pytest.raises(ValueError, match="Unknown augmentation"):
        port_dataset.ClassposeHDF5Dataset(str(jax_file),
                                          augmentation_strategy="nope")
