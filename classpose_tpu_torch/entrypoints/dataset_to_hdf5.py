"""``classpose-dataset-to-hdf5-torch``: npy arrays → the HDF5 training
format (counterpart of the JAX package's ``classpose-dataset-to-hdf5``,
with the same arguments and the same file):

    python -m classpose_tpu_torch.entrypoints.dataset_to_hdf5 \\
        --data_path DIR --output train.h5 [--device cpu]

Reads ``images.npy`` / ``labels.npy`` (instance, class) from
``--data_path``, makes the 5-channel training labels [instance, class,
binary, flow_y, flow_x] (the flow targets by the diffusion on
``--device``: the CUDA kernel on the card; ``auto`` means CUDA), and
writes ``images`` and ``labels`` chunked one sample per chunk with gzip
level 2, plus the ``class_counts``, ``instance_counts`` and ``diameters``
that the HDF5 dataset reads instead of scanning the labels. The file is
written by the package's own writer (``io/hdf5.py``) in the layout h5py
writes.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def main(args):
    from classpose_tpu_torch.io import hdf5
    from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
    from classpose_tpu_torch.train.train_utils import (
        load_data_arrays,
        process_train_test,
    )

    device = "cuda" if args.device == "auto" else args.device
    images, labels = load_data_arrays(
        str(Path(args.data_path) / "images.npy"),
        str(Path(args.data_path) / "labels.npy"),
    )
    tr_d, tr_l, tr_diam, *_ = process_train_test(
        images, labels, min_train_masks=args.min_train_masks, device=device)
    data = np.stack(tr_d).astype(np.float32)
    labs = np.stack(tr_l).astype(np.float32)

    ds = ClassposeTrainingDataset(data, labs, diameter_array=tr_diam,
                                  augment=False)
    class_counts = ds.class_counts
    instance_counts = ds.instance_counts

    out = Path(args.output)
    with hdf5.Writer(out) as f:
        f.create_dataset("images", data=data, chunks=(1,) + data.shape[1:],
                         compression="gzip", compression_opts=2)
        f.create_dataset("labels", data=labs, chunks=(1,) + labs.shape[1:],
                         compression="gzip", compression_opts=2)
        f.create_dataset("class_counts", data=class_counts)
        f.create_dataset("instance_counts", data=instance_counts)
        f.create_dataset("diameters", data=np.asarray(tr_diam))
    logger.info("wrote %s: %d samples, %d classes", out, len(data),
                len(class_counts))
    return out


def main_with_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert npy arrays to the HDF5 training format."
    )
    p.add_argument("--data_path", required=True,
                   help="Directory with images.npy and labels.npy")
    p.add_argument("--output", required=True, help="Output .h5 path")
    p.add_argument("--min_train_masks", type=int, default=5)
    p.add_argument("--device", type=str, default="auto",
                   help="where the flow targets are made: auto (= cuda), "
                   "cuda or cpu")
    return main(p.parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main_with_args()
