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

Run: python tests/golden/regenerate_hdf5.py
"""

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent
H5_NAME, JSON_NAME = "hdf5_latest.h5", "hdf5_golden.json"
N_IMAGES, SIZE = 8, 48


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
        {"file": H5_NAME, "datasets": dict(sorted(golden.items()))},
        indent=1) + "\n")
    print(f"wrote {out} ({out.stat().st_size} bytes), {len(golden)} "
          f"datasets")


if __name__ == "__main__":
    main()
