"""Host helpers the trainer and its CLI use (counterpart of the parts of
``classpose_tpu/utils.py`` they call)."""

from __future__ import annotations

import numpy as np


def make_sparse(labels: np.ndarray, keep_fraction: float,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Sparsify class annotations: keep the class labels of only
    ``keep_fraction`` of the annotated instances and set the rest to 0
    (unannotated). ``labels`` is (N, C, H, W) or one (C, H, W) sample with
    channel 0 the class channel and channel 1 the instance channel."""
    rng = rng or np.random.default_rng()
    labels = labels.copy()
    squeeze = labels.ndim == 3
    if squeeze:
        labels = labels[None]
    for i in range(labels.shape[0]):
        cls, inst = labels[i, 0], labels[i, 1]
        ids = np.unique(inst)
        ids = ids[ids > 0]
        if len(ids) == 0:
            continue
        n_keep = max(1, int(round(keep_fraction * len(ids))))
        keep = rng.choice(ids, size=n_keep, replace=False)
        cls[(inst > 0) & ~np.isin(inst, keep)] = 0
        labels[i, 0] = cls
    return labels[0] if squeeze else labels
