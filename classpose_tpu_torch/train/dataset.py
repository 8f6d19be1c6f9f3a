"""Training datasets with per-item augmentation (counterpart of
``classpose_tpu/train/dataset.py``).

``ClassposeDataset`` is the base with lazy class and instance counts and
``subset()``; ``ClassposeTrainingDataset`` holds images (N, C, H, W) and
labels (N, 5, H, W) in memory; ``ClassposeHDF5Dataset`` reads them item by
item from an HDF5 file with ``images`` and ``labels`` [instance, class,
binary, flow_y, flow_x], and takes the cached ``class_counts``,
``instance_counts`` and ``diameters`` where the file has them (the
package's own reader, ``io/hdf5.py``). An item is the optional StarDist
augmentation (``augmentation_strategy``: a name of
``transforms.AUGMENTATION_CONFIGS`` or a config dict), then a random
rotate/scale/crop to ``bsize``, then a per-channel 1–99 percentile
normalization: (image (3, b, b) float32, label (4, b, b) [class, binary,
fy, fx]). The augmentation pipeline is built unseeded, as in the JAX
package: its draws differ from run to run.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any

import numpy as np

from classpose_tpu_torch.io import hdf5
from classpose_tpu_torch.train.augment import random_rotate_and_resize
from classpose_tpu_torch.train.train_utils import (
    get_class_counts,
    get_class_weights,
)


def _normalize_percentile(img: np.ndarray) -> np.ndarray:
    out = np.zeros_like(img, np.float32)
    for c in range(img.shape[0]):
        lo, hi = np.percentile(img[c], 1), np.percentile(img[c], 99)
        out[c] = (img[c] - lo) / max(hi - lo, 1e-3)
    return out


def augment_single_image(
    img: np.ndarray,
    lbl: np.ndarray,
    diam: float,
    diam_mean: float,
    rescale: bool,
    scale_range,
    bsize: int,
    normalize_params: dict[str, Any] | None,
    augment: bool,
    augment_pipeline=None,
    rng: np.random.Generator | None = None,
):
    rsc = diam / diam_mean if rescale else 1.0
    if augment:
        if augment_pipeline is not None:
            img = augment_pipeline.transform(img)
        img, lbl, _ = random_rotate_and_resize(
            img, lbl, rescale=rsc,
            scale_range=scale_range if scale_range is not None else 0.5,
            xy=(bsize, bsize), rng=rng,
        )
    img = _normalize_percentile(np.asarray(img, np.float32))
    return np.ascontiguousarray(img), np.ascontiguousarray(
        np.asarray(lbl, np.float32)
    )


class ClassposeDataset:
    """Base dataset: shared config + lazy statistics + subsetting."""

    def __init__(
        self,
        augmentation_strategy: str | None = None,
        diam_mean: float = 30.0,
        rescale: bool = True,
        scale_range=0.5,
        bsize: int = 256,
        normalize_params: dict[str, Any] | None = None,
        augment: bool = True,
        n_classes: int | None = None,
        seed: int = 0,
    ):
        self.diam_mean = diam_mean
        self.rescale = rescale
        self.scale_range = scale_range
        self.bsize = bsize
        self.normalize_params = normalize_params
        self.augment = augment
        self.n_classes = n_classes
        self.diameter_array = None
        self._class_counts = None
        self._instance_counts = None
        self._class_weights = None
        self._is_subset = False
        self._rng = np.random.default_rng(seed)
        self.augment_pipeline = None
        if augmentation_strategy is not None:
            from classpose_tpu_torch.transforms import (
                create_stardist_augmentation,
            )

            self.augment_pipeline = create_stardist_augmentation(
                augmentation_strategy)

    # ---- to be provided by subclasses: self.indices, self.length,
    # _get_class_map(idx), _get_instance_map(idx)
    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx):
        raise NotImplementedError

    def subset(self, indices) -> "ClassposeDataset":
        indices = sorted(indices)
        if len(indices) == 0:
            raise ValueError("cannot create an empty subset")
        if max(indices) >= self.length:
            raise IndexError("subset index out of range")
        ds = deepcopy(self)
        ds.indices = ds.indices[indices]
        ds.length = len(indices)
        if ds.diameter_array is not None:
            ds.diameter_array = ds.diameter_array[indices]
        ds._instance_counts = None
        ds._class_counts = None
        ds._class_weights = None
        ds._is_subset = True
        return ds

    def initialise_diameter_array_if_necessary(self):
        if self.diameter_array is None:
            self.diameter_array = np.ones(self.length) * self.diam_mean

    def _resolve_n_classes(self) -> int:
        if self.n_classes is not None:
            return self.n_classes
        m = 0
        for i in range(self.length):
            cm = self._get_class_map(i)
            m = max(m, int(cm[cm >= 0].max()) if (cm >= 0).any() else 0)
        self.n_classes = m + 1
        return self.n_classes

    @property
    def class_counts(self) -> np.ndarray:
        if self._class_counts is None:
            n = self._resolve_n_classes()
            self._class_counts = get_class_counts(
                (self._get_class_map(i) for i in range(self.length)), n
            )
        return self._class_counts

    @property
    def instance_counts(self) -> np.ndarray:
        """(N, n_classes) per-sample instance counts by class."""
        if self._instance_counts is None:
            n = self._resolve_n_classes()
            out = np.zeros((self.length, n), np.int64)
            for i in range(self.length):
                cm = self._get_class_map(i)
                im = self._get_instance_map(i)
                ids = np.unique(im[im > 0])
                for inst in ids:
                    vals = cm[(im == inst) & (cm >= 0)]
                    if vals.size:
                        out[i, int(vals[0])] += 1
            self._instance_counts = out
        return self._instance_counts

    @property
    def class_weights(self) -> np.ndarray:
        if self._class_weights is None:
            self._class_weights = get_class_weights(self.class_counts)
        return self._class_weights


class ClassposeTrainingDataset(ClassposeDataset):
    """In-memory dataset over images (N, C, H, W) + labels (N, 5, H, W)
    [instance, class, binary, flow_y, flow_x]."""

    def __init__(self, data_array, label_array, diameter_array=None, **kw):
        super().__init__(**kw)
        self.data_array = data_array
        self.label_array = label_array
        self.length = len(data_array)
        self.indices = np.arange(self.length)
        self.diameter_array = (
            np.asarray(diameter_array) if diameter_array is not None else None
        )
        self.initialise_diameter_array_if_necessary()

    def _get_class_map(self, i):
        return np.asarray(self.label_array[self.indices[i]][1])

    def _get_instance_map(self, i):
        return np.asarray(self.label_array[self.indices[i]][0])

    def __getitem__(self, index: int):
        idx = self.indices[index]
        return augment_single_image(
            np.asarray(self.data_array[idx], np.float32),
            np.asarray(self.label_array[idx][1:], np.float32),
            float(self.diameter_array[index]),
            diam_mean=self.diam_mean,
            rescale=self.rescale,
            scale_range=self.scale_range,
            bsize=self.bsize,
            normalize_params=self.normalize_params,
            augment=self.augment,
            augment_pipeline=self.augment_pipeline,
            rng=self._rng,
        )


class ClassposeHDF5Dataset(ClassposeDataset):
    """Out-of-core dataset over an HDF5 file with ``images`` (N, C, H, W)
    and ``labels`` (N, 5, H, W); the cached ``class_counts`` /
    ``instance_counts`` / ``diameters`` datasets are used when present.
    ``keep_open`` keeps one handle for the dataset's life (dropped when
    pickled); otherwise every read opens the file."""

    def __init__(self, h5_path: str, keep_open: bool = False,
                 diameter_array=None, **kw):
        super().__init__(**kw)
        self.h5_path = str(h5_path)
        self.keep_open = keep_open
        self._fh = None
        with hdf5.File(self.h5_path) as f:
            self.length = f["images"].shape[0]
            if "class_counts" in f:
                self._class_counts = np.asarray(f["class_counts"])
                self.n_classes = len(self._class_counts)
            if "instance_counts" in f:
                self._instance_counts = np.asarray(f["instance_counts"])
            if "diameters" in f and diameter_array is None:
                diameter_array = np.asarray(f["diameters"])
        self.indices = np.arange(self.length)
        self.diameter_array = (
            np.asarray(diameter_array) if diameter_array is not None else None
        )
        self.initialise_diameter_array_if_necessary()

    def _file(self) -> hdf5.File:
        if self.keep_open:
            if self._fh is None:
                self._fh = hdf5.File(self.h5_path)
            return self._fh
        return hdf5.File(self.h5_path)

    def _get(self, name, idx):
        f = self._file()
        try:
            return np.asarray(f[name][idx])
        finally:
            if not self.keep_open:
                f.close()

    def _get_class_map(self, i):
        return self._get("labels", int(self.indices[i]))[1]

    def _get_instance_map(self, i):
        return self._get("labels", int(self.indices[i]))[0]

    def __getitem__(self, index: int):
        idx = int(self.indices[index])
        img = self._get("images", idx).astype(np.float32)
        lbl = self._get("labels", idx)[1:].astype(np.float32)
        return augment_single_image(
            img,
            lbl,
            float(self.diameter_array[index]),
            diam_mean=self.diam_mean,
            rescale=self.rescale,
            scale_range=self.scale_range,
            bsize=self.bsize,
            normalize_params=self.normalize_params,
            augment=self.augment,
            augment_pipeline=self.augment_pipeline,
            rng=self._rng,
        )

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_fh"] = None
        return state
