"""Regenerate ``hdf5_latest.h5`` and ``hdf5_golden.json``: a small
training set of synthetic disc images as the JAX ``dataset_to_hdf5``
writes it (``images``, ``labels``, ``class_counts``, ``instance_counts``,
``diameters``), rewritten by h5py past its defaults, so that the port's
HDF5 reader (``classpose_tpu_torch/io/hdf5.py``) is held to h5py on the
layouts a user meets (``tests/test_torch_hdf5.py``) and runs on the card's
machine, which has no h5py (``chip_smoke.py``):

- the file under ``libver="latest"``: superblock 3, version 2 object
  headers, link messages;
- ``images`` chunked one image a chunk (a fixed-array chunk index), with
  shuffle, deflate and fletcher32;
- ``labels`` with ``maxshape=(None, ...)`` (an extensible-array index),
  with lzf;
- ``instance_counts`` with szip; ``class_counts`` (int64) in a compact
  layout; ``diameters`` big-endian float64;
- a group ``extras`` of 10 links (dense link storage: a fractal heap and a
  version 2 B-tree), one of them a scalar dataset and one a soft link.

``hdf5_golden.json`` records, for every dataset as h5py reads it, its
dtype (byte order included), shape and the SHA-256 of its bytes.

Beside it, under ``"more"``, the same digests (and the dangling soft
links, by name) of four smaller files, each written through h5py and, for
what h5py does not wrap, the libhdf5 it loads (ctypes):

- ``hdf5_default.h5``: the first 4 images at h5py's defaults (superblock
  0, symbol-table groups): ``images`` and ``labels`` in a group ``data``,
  named at the root by soft links (absolute and relative), a soft link to
  the group, a relative one inside it, a dangling one, and
  ``instance_counts`` (int16) under lzf after scaleoffset in chunks of 6
  values, where scaleoffset's output outgrows the chunk;
- ``hdf5_shared_list.h5`` and ``hdf5_shared_btree.h5``: shared object
  header messages (one index for dataspace, datatype, fill value and
  filter pipeline messages, ``H5Pset_shared_mesg_index``), its records in
  a list (``SMLI``) and in a version 2 B-tree from the first message
  (``H5Pset_shared_mesg_phase_change(fcpl, 0, 0)``);
- ``hdf5_nbit.h5``: the nbit filter at reduced precision
  (:data:`NBIT_TYPES`): integers signed and unsigned at precisions below
  their size and nonzero offsets, floats with narrower mantissas (and one
  with a narrower exponent), in both byte orders.

Run: python tests/golden/regenerate_hdf5.py (needs h5py and the JAX
package, so it runs where they are installed)
"""

import argparse
import ctypes
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent
H5_NAME, JSON_NAME = "hdf5_latest.h5", "hdf5_golden.json"
DEFAULT_NAME, NBIT_NAME = "hdf5_default.h5", "hdf5_nbit.h5"
SHARED_NAMES = {"list": "hdf5_shared_list.h5",
                "btree": "hdf5_shared_btree.h5"}
N_IMAGES, SIZE = 8, 48
N_DEFAULT = 4
# H5O_SHMESG_{SDSPACE,DTYPE,FILL,PLINE}_FLAG: one bit per message type
SHARE_ALL = (1 << 1) | (1 << 3) | (1 << 5) | (1 << 11)


def disc_images(n: int, size: int, seed: int = 0):
    """(images (3, H, W) float32 of whole numbers, labels (2, H, W)
    [instance, class]) of random discs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    images, labels = [], []
    for _ in range(n):
        inst = np.zeros((size, size), np.float32)
        cls = np.zeros((size, size), np.float32)
        k = 0
        for _ in range(5):
            r = rng.integers(4, 9)
            cy, cx = rng.integers(r, size - r, 2)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (inst == 0)
            if m.sum() < 10:
                continue
            k += 1
            inst[m] = k
            cls[m] = rng.integers(1, 4)
        img = np.stack([200 - 60 * (inst > 0)] * 3) + \
            rng.integers(0, 30, (3, size, size))
        images.append(img.astype(np.float32))
        labels.append(np.stack([inst, cls]))
    return np.stack(images), np.stack(labels)


def digest(a: np.ndarray) -> dict:
    a = np.asarray(a)
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(a).tobytes()).hexdigest()}


def hdf5_lib() -> ctypes.CDLL:
    """The libhdf5 that h5py loads, for the property-list calls h5py does
    not wrap."""
    import h5py

    libs = Path(h5py.__file__).parent.parent / "h5py.libs"
    return ctypes.CDLL(str(next(libs.glob("libhdf5-*.so*"))))


def shared_file(path, index: str, flags: int = SHARE_ALL, min_size: int = 0,
                libver: str | None = None):
    """A new h5py file whose creation list holds one shared message index
    for the message types of ``flags`` of at least ``min_size`` bytes,
    its records in a list or (``index="btree"``) in a version 2 B-tree
    from the first message."""
    import h5py

    lib = hdf5_lib()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    pl = ctypes.c_int64(fcpl.id)
    ok = [lib.H5Pset_shared_mesg_nindexes(pl, 1),
          lib.H5Pset_shared_mesg_index(pl, 0, flags, min_size)]
    if index == "btree":
        ok.append(lib.H5Pset_shared_mesg_phase_change(pl, 0, 0))
    if min(ok) < 0:
        raise RuntimeError("libhdf5 refused the shared message settings")
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver:
        fapl.set_libver_bounds(*[getattr(h5py.h5f, f"LIBVER_"
                                         f"{libver.upper()}")] * 2)
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC,
                                     fcpl=fcpl, fapl=fapl))


def nbit_type(base, precision: int, offset: int = 0, fields=None,
              ebias=None):
    """A copy of the h5py type ``base`` at ``precision`` bits from
    ``offset``; a float's ``fields`` (sign, exponent position and size,
    mantissa position and size) set first, as HDF5's own nbit test sets
    them, then its size put back."""
    t = base.copy()
    size = t.get_size()
    if fields:
        t.set_fields(*fields)
    t.set_offset(offset)
    t.set_precision(precision)
    t.set_size(size)
    if ebias is not None:
        t.set_ebias(ebias)
    return t


def nbit_dataset(group, name: str, tid, data: np.ndarray, chunks) -> None:
    """``data`` written through the nbit filter as the type ``tid``."""
    import h5py

    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(tuple(chunks))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    h5py.h5d.create(group.id, name.encode(), tid,
                    h5py.h5s.create_simple(data.shape), dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data)


def _float_values(rng, n: int, dtype: str) -> np.ndarray:
    """Normal values, a few special ones first (zeros of both signs, the
    infinities, a NaN, values too small and too large for the type)."""
    a = rng.normal(0, 100, n)
    a[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30, -3e-39, 1e30]
    with np.errstate(over="ignore"):
        return a.astype(dtype)


def nbit_types(rng) -> dict:
    """Name → (h5py type, data) of the nbit datasets."""
    import h5py

    t = h5py.h5t
    m10 = (31, 23, 8, 13, 10)
    return {
        "u16_12": (nbit_type(t.STD_U16LE, 12),
                   rng.integers(0, 5000, (16, 4)).astype("<u2")),
        "u8_3_offset_2": (nbit_type(t.STD_U8LE, 3, 2),
                          rng.integers(0, 9, (16, 4)).astype("u1")),
        "i32_20_offset_4": (nbit_type(t.STD_I32LE, 20, 4), rng.integers(
            -2 ** 20, 2 ** 20, (16, 4)).astype("<i4")),
        "i32be_20_offset_4": (nbit_type(t.STD_I32BE, 20, 4), rng.integers(
            -2 ** 19, 2 ** 19, (16, 4)).astype(">i4")),
        "i64_40_offset_9": (nbit_type(t.STD_I64LE, 40, 9), rng.integers(
            -2 ** 39, 2 ** 39, (16, 4)).astype("<i8")),
        "f32_mantissa_10": (nbit_type(t.IEEE_F32LE, 19, 13, m10),
                            _float_values(rng, 64, "<f4").reshape(16, 4)),
        "f32be_mantissa_10": (nbit_type(t.IEEE_F32BE, 19, 13, m10),
                              _float_values(rng, 64, ">f4").reshape(16, 4)),
        "f64_mantissa_20": (nbit_type(t.IEEE_F64LE, 32, 32,
                                      (63, 52, 11, 32, 20)),
                            _float_values(rng, 64, "<f8").reshape(16, 4)),
        # HDF5's own nbit test type: a 6-bit exponent of bias 31
        "f32_exponent_6": (nbit_type(t.IEEE_F32LE, 20, 7,
                                     (26, 20, 6, 7, 13), ebias=31),
                           _float_values(rng, 64, "<f4").reshape(16, 4)),
    }


def listing(f) -> tuple[dict, list]:
    """Every dataset name of an h5py file as the port's reader lists them
    (groups walked, soft links to groups followed; no cycles here) →
    digest, and the dangling soft links' names."""
    import h5py

    out, dangling = {}, []

    def walk(group, prefix):
        for k in group:
            obj = group.get(k)
            if obj is None:
                dangling.append(prefix + k)
            elif isinstance(obj, h5py.Group):
                walk(obj, f"{prefix}{k}/")
            else:
                out[prefix + k] = digest(obj[()])

    walk(f, "")
    return dict(sorted(out.items())), sorted(dangling)


def write_default(path: Path, arrays: dict) -> None:
    """The training set's first ``N_DEFAULT`` images at h5py's defaults,
    its arrays named through soft links (see the module docstring)."""
    import h5py

    n = N_DEFAULT
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for k in ("images", "labels"):
            a = arrays[k][:n]
            data.create_dataset(k, data=a, chunks=(1,) + a.shape[1:],
                                shuffle=True, compression="gzip",
                                compression_opts=9)
        f["images"] = h5py.SoftLink("/data/images")
        f["labels"] = h5py.SoftLink("data/labels")
        data["first_labels"] = h5py.SoftLink("labels")
        f["everything"] = h5py.SoftLink("/data")
        f["notes"] = h5py.SoftLink("/notes_never_written")
        counts = arrays["instance_counts"][:n].astype("<i2")
        f.create_dataset("instance_counts", data=counts,
                         chunks=(2, counts.shape[1]), compression="lzf",
                         scaleoffset=0)
        f.create_dataset("class_counts", data=arrays["class_counts"])
        f.create_dataset("diameters", data=arrays["diameters"][:n])


def write_shared(path: Path, index: str, rng) -> None:
    """Datasets whose dataspace, datatype, fill value and filter pipeline
    messages are shared, in the heap and in the first header that holds
    each; an nbit dataset among them (its pipeline shared too)."""
    with shared_file(path, index) as f:
        for i in range(3):
            f.create_dataset(f"f4_{i}", data=rng.normal(0, 9, (3, 4)).astype(
                "<f4"), chunks=(1, 4), compression="gzip", fillvalue=7.5)
        g = f.create_group("more")
        for i in range(2):
            g.create_dataset(f"i2_{i}", data=rng.integers(
                -99, 99, 9).astype("<i2"), chunks=(3,), shuffle=True,
                compression="gzip")
        g.create_dataset("be", data=np.arange(5, dtype=">f8"))
        g.create_dataset("partly_written", shape=(6, 4), dtype="<f4",
                         chunks=(1, 4), compression="gzip",
                         fillvalue=7.5)[2] = 1.0
        tid, a = nbit_types(rng)["i32_20_offset_4"]
        for i in range(2):
            nbit_dataset(g, f"nbit_{i}", tid, a + i, (4, 4))
        f["f4_0"].attrs["note"] = "attributes are skipped"


def main():
    import h5py

    sys.path.insert(0, str(HERE.parents[1]))
    from classpose_tpu.entrypoints import dataset_to_hdf5

    images, labels = disc_images(N_IMAGES, SIZE)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "images.npy", images)
        np.save(Path(tmp) / "labels.npy", labels)
        dataset_to_hdf5.main(argparse.Namespace(
            data_path=tmp, output=f"{tmp}/jax.h5", min_train_masks=1))
        with h5py.File(f"{tmp}/jax.h5", "r") as f:
            arrays = {k: f[k][()] for k in f}
    write_more(arrays)
    out = HERE / H5_NAME
    with h5py.File(out, "w", libver="latest") as f:
        img = arrays["images"]
        f.create_dataset("images", data=img, chunks=(1,) + img.shape[1:],
                         shuffle=True, compression="gzip", compression_opts=4,
                         fletcher32=True)
        lab = arrays["labels"]
        f.create_dataset("labels", data=lab, chunks=(1,) + lab.shape[1:],
                         maxshape=(None,) + lab.shape[1:], compression="lzf")
        f.create_dataset("instance_counts", data=arrays["instance_counts"],
                         chunks=arrays["instance_counts"].shape,
                         compression="szip", compression_opts=("nn", 4))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        cc = np.ascontiguousarray(arrays["class_counts"], np.int64)
        h5py.h5d.create(f.id, b"class_counts", h5py.h5t.STD_I64LE,
                        h5py.h5s.create_simple(cc.shape), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, cc)
        f.create_dataset("diameters",
                         data=arrays["diameters"].astype(">f8"))
        g = f.create_group("extras")
        for i in range(8):
            g.create_dataset(f"note_{i}", data=np.arange(i + 1, dtype="i2"))
        g.create_dataset("scale", data=0.5)
        g["first_note"] = h5py.SoftLink("/extras/note_0")
    golden = {}
    with h5py.File(out, "r") as f:
        f.visititems(lambda name, obj: golden.__setitem__(
            name, digest(obj[()])) if isinstance(obj, h5py.Dataset)
            else None)
        golden["extras/first_note"] = digest(f["extras/first_note"][()])
    raw = out.read_bytes()
    assert raw[8] == 3 and b"FRHP" in raw and b"BTHD" in raw  # dense links
    assert b"FAHD" in raw and b"EAHD" in raw    # fixed, extensible arrays
    (HERE / JSON_NAME).write_text(json.dumps(
        {"file": H5_NAME, "datasets": dict(sorted(golden.items())),
         "more": more_digests()}, indent=1) + "\n")
    print(f"wrote {out} ({out.stat().st_size} bytes), {len(golden)} "
          f"datasets")


def write_more(arrays: dict) -> None:
    """The four smaller goldens of the module docstring."""
    import h5py

    rng = np.random.default_rng(21)
    write_default(HERE / DEFAULT_NAME, arrays)
    for index, name in SHARED_NAMES.items():
        write_shared(HERE / name, index, rng)
    with h5py.File(HERE / NBIT_NAME, "w") as f:
        for name, (tid, a) in nbit_types(rng).items():
            nbit_dataset(f, name, tid, a, (4, 4))
    raw = {n: (HERE / n).read_bytes() for n in (DEFAULT_NAME,
                                                *SHARED_NAMES.values())}
    assert raw[DEFAULT_NAME][8] == 0 and b"SNOD" in raw[DEFAULT_NAME]
    assert b"SMLI" in raw[SHARED_NAMES["list"]]
    assert b"SMLI" not in raw[SHARED_NAMES["btree"]] and \
        b"BTHD" in raw[SHARED_NAMES["btree"]]


def more_digests() -> dict:
    """File name → its datasets' digests and dangling links, as h5py
    reads them."""
    import h5py

    out = {}
    for name in (DEFAULT_NAME, *SHARED_NAMES.values(), NBIT_NAME):
        with h5py.File(HERE / name, "r") as f:
            datasets, dangling = listing(f)
        out[name] = {"datasets": datasets, "dangling": dangling}
    return out


if __name__ == "__main__":
    main()
