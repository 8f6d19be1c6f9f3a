"""The training data path end to end on the CPU, the port against the
JAX package: ``classpose-dataset-to-hdf5`` (JAX ``main``) and
``classpose-dataset-to-hdf5-torch`` (``--device cpu``) on the same npy
arrays write equal files (the flows within the 1e-6 target contract of
``tests/test_torch_data.py``, every other array bitwise, the same chunks
and filters); then ``classpose-train-torch --tiny_model --device cpu
--augmentation enhanced`` trains one epoch on the JAX-written file and on
its own."""

import argparse
import json
from pathlib import Path

import h5py
import numpy as np
import pytest

from classpose_tpu.entrypoints import dataset_to_hdf5 as jax_to_hdf5
from classpose_tpu_torch.entrypoints import dataset_to_hdf5 as port_to_hdf5
from classpose_tpu_torch.entrypoints.run_training import (
    main_with_args as train_main,
)
from classpose_tpu_torch.io import hdf5

from test_torch_data import assert_targets_match, disc_sample


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    data, labels = zip(*[disc_sample(i, H=64, W=64, n=5, n_classes=3)
                         for i in range(8)])
    np.save(d / "images.npy", np.stack(data))
    np.save(d / "labels.npy", np.stack(labels))
    jax_to_hdf5.main(argparse.Namespace(
        data_path=str(d), output=str(d / "jax.h5"), min_train_masks=1))
    out = port_to_hdf5.main_with_args([
        "--data_path", str(d), "--output", str(d / "port.h5"),
        "--min_train_masks", "1", "--device", "cpu"])
    assert out == d / "port.h5"
    return d / "jax.h5", d / "port.h5"


def test_dataset_to_hdf5_matches_jax(files):
    jax_path, port_path = files
    with h5py.File(jax_path, "r") as a, h5py.File(port_path, "r") as b, \
            hdf5.File(port_path) as c:
        assert set(a) == set(b) == set(c)
        for name in a:
            x, y = a[name][()], b[name][()]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), name
            assert a[name].chunks == b[name].chunks, name
            assert (a[name].compression, a[name].compression_opts) == \
                (b[name].compression, b[name].compression_opts), name
            assert np.asarray(c[name]).tobytes() == y.tobytes()
            if name == "labels":
                for i in range(len(x)):
                    assert_targets_match(y[i], x[i])
            else:
                assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("which", ["jax", "port"])
def test_train_cli_on_hdf5(files, tmp_path, which):
    path = files[0] if which == "jax" else files[1]
    out = train_main([
        "--data_path", str(path), "--augmentation", "enhanced",
        "--tiny_model", "--device", "cpu", "--epochs", "1",
        "--batch_size", "2", "--bsize", "32", "--seed", "0",
        "--output_dir", str(tmp_path), "--model_name", which])
    assert out == str(tmp_path / which / f"{which}.npz")
    meta = json.loads((Path(out).parent / "checkpoint_last.train" /
                       "meta.json").read_text())
    assert len(meta["train_losses"]) == 1
    assert np.isfinite(meta["train_losses"]).all()
    assert np.isfinite(meta["test_losses"]).all()
