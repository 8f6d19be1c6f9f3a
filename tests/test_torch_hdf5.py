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
import pickle

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


@pytest.mark.parametrize("feature,write,kw,match", [
    ("latest", lambda f: f.create_dataset("x", data=np.arange(4)),
     dict(libver="latest"), "superblock version 3"),
    ("v2_headers", lambda f: f.create_dataset("x", data=np.arange(4)),
     dict(track_order=True), "version 2 object headers"),
    ("shuffle", lambda f: f.create_dataset(
        "x", data=np.ones((4, 10)), chunks=(1, 10), shuffle=True,
        compression="gzip"), {}, "shuffle filter"),
    ("fletcher32", lambda f: f.create_dataset(
        "x", data=np.ones((4, 10)), chunks=(1, 10), fletcher32=True), {},
     "fletcher32 filter"),
    ("big_endian", _write_big_endian, {}, "big-endian"),
    ("compound", lambda f: f.create_dataset(
        "x", data=np.zeros(3, dtype=[("a", "<f4"), ("b", "<i4")])), {},
     "compound datatypes"),
    ("vlen", lambda f: f.create_dataset(
        "x", data=["ab", "c"], dtype=h5py.string_dtype()), {},
     "variable-length datatypes"),
    ("scalar", lambda f: f.create_dataset("x", data=1.5), {},
     "scalar datasets"),
])
def test_reader_refuses(tmp_path, feature, write, kw, match):
    path = tmp_path / f"{feature}.h5"
    with h5py.File(path, "w", **kw) as f:
        write(f)
    with pytest.raises(ValueError, match=match):
        hdf5.File(path)


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
