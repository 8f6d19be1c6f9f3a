"""Training data processing: label splitting and masking, ground-truth
flows, diameters, class weights, oversampling (counterpart of
``classpose_tpu/train/train_utils.py``).

- the class channel is the last label channel; class pixels are masked to
  −100 wherever class and instance foreground disagree (sparse
  annotation);
- samples whose instance map has exactly one positive pixel are dropped;
- ``labels_to_flows`` over the instance labels (the diffusion runs on
  ``device``: the CUDA kernel on the card);
- per-image diameters (median instance diameter, at least 5) and the
  ``min_train_masks`` filter;
- median-frequency inverse-sqrt class weights (StarDist CoNIC recipe);
- instance-weighted inverse-class-frequency oversampling probabilities
  and StarDist-style ``oversample_classes``.
"""

from __future__ import annotations

import logging

import numpy as np

from classpose_tpu_torch.dynamics.flows import labels_to_flows

logger = logging.getLogger(__name__)


def split_labels(
    labels: list[np.ndarray], mask_classes: bool = True
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Split (C+1, H, W) labels into (instance..., class) with −100 masking
    of inconsistent class pixels."""
    classes = [lab[-1:] for lab in labels]
    labels = [lab[:-1] for lab in labels]
    if mask_classes:
        for i in range(len(classes)):
            cls = classes[i].astype(np.int16)
            cls[np.logical_and(labels[i][0] == 0, cls > 0)] = -100
            cls[np.logical_and(labels[i][0] > 0, cls == 0)] = -100
            classes[i] = cls
    return labels, classes


def filter_single_pixel_instances(images, labels):
    """Drop samples whose instance map has exactly one positive pixel."""
    keep_images, keep_labels, removed = [], [], 0
    for img, lab in zip(images, labels):
        if np.nonzero(lab[0])[0].size == 1:
            removed += 1
            continue
        keep_images.append(img)
        keep_labels.append(lab)
    if removed:
        logger.info(f"Removed {removed} images with a single pixel instance")
    return keep_images, keep_labels


def diameters(masks: np.ndarray) -> float:
    """Median equivalent-circle diameter of the instances."""
    ids, counts = np.unique(masks.astype(np.int64), return_counts=True)
    counts = counts[ids > 0]
    if counts.size == 0:
        return 0.0
    md = np.median(counts**0.5)
    return float(md * (np.pi**-0.5) * 2)


def compute_diameter_array(labels, min_diameter: float = 5.0) -> np.ndarray:
    return np.array(
        [max(diameters(lab[0]), min_diameter) for lab in labels],
        np.float32,
    )


def count_masks(lab) -> int:
    ids = np.unique(lab[0])
    return int((ids > 0).sum())


def filter_min_train_masks(images, labels, classes, diams,
                           min_train_masks: int = 5):
    keep = [count_masks(lab) >= min_train_masks for lab in labels]
    n_removed = len(keep) - sum(keep)
    if n_removed:
        logger.info(
            f"{n_removed} train images with number of masks less than "
            f"min_train_masks ({min_train_masks}), removing from train set"
        )
    f = lambda lst: [x for x, k in zip(lst, keep) if k]  # noqa: E731
    return f(images), f(labels), f(classes), diams[np.asarray(keep, bool)]


def get_class_counts(class_maps, n_classes: int) -> np.ndarray:
    counts = np.zeros(n_classes, np.int64)
    for cm in class_maps:
        cm = np.asarray(cm)
        v = cm[(cm >= 0) & (cm < n_classes)].astype(np.int64)
        counts += np.bincount(v, minlength=n_classes)
    return counts


def get_class_weights(class_counts: np.ndarray) -> np.ndarray:
    """Median-frequency inverse with sqrt scaling (StarDist CoNIC
    recipe)."""
    class_counts = np.asarray(class_counts)
    positive = class_counts[class_counts > 0]
    if positive.size == 0:
        raise ValueError(
            "Cannot compute class weights with no positive class counts"
        )
    median_count = np.median(positive)
    inv = np.zeros_like(class_counts, np.float64)
    inv[class_counts > 0] = median_count / class_counts[class_counts > 0]
    weights = (inv**0.5).round(4)
    logger.info(f"class weights = {weights.tolist()}")
    return weights


def compute_oversampling_probabilities(
    class_counts: np.ndarray, instance_counts: np.ndarray, power: float = 1
) -> np.ndarray:
    """Instance-weighted inverse-class-frequency sampling
    probabilities."""
    class_counts = np.asarray(class_counts)
    class_weights = np.zeros_like(class_counts, np.float64)
    class_weights[class_counts > 0] = 1.0 / class_counts[class_counts > 0]
    class_weights[0] = 0
    weights = np.sum(np.asarray(instance_counts) * class_weights[None], 1)
    weights = weights**power
    return weights / weights.sum()


def oversample_classes(
    X: np.ndarray, Y: np.ndarray, n_extra_classes: int = 4, seed=None
) -> tuple[np.ndarray, np.ndarray]:
    """Duplicate samples rich in rare classes (StarDist recipe). ``Y`` is
    (N, 2, H, W) [instance, class]."""
    y0 = Y[:, 1]
    rng = np.random.default_rng(seed)
    n_classes = int(y0.max()) + 1
    class_counts = get_class_counts(y0, n_classes)
    extra_classes = np.argsort(class_counts)[:n_extra_classes]
    for c in extra_classes:
        if class_counts[c] == 0:
            logger.critical(f"count 0 for class {c}")
    n_extras = np.sqrt(
        np.sum(class_counts[1:]) / np.maximum(class_counts[extra_classes], 1)
    )
    n_extras = n_extras / np.max(n_extras)
    logger.info(f"oversample classes: {extra_classes}")
    idx_take = np.arange(len(X))
    for c, n_extra in zip(extra_classes, n_extras):
        prob = np.sum(y0[:, ::2, ::2] == c, axis=(1, 2)).astype(np.float64)
        prob = np.clip(prob, 0, np.percentile(prob, 99.8))
        prob = prob**2
        if prob.sum() == 0:
            continue
        prob = prob / prob.sum()
        n_extra = int(n_extra * len(X))
        logger.info(f"adding {n_extra} images of class {c}")
        idx_take = np.append(
            idx_take, rng.choice(np.arange(len(X)), n_extra, p=prob)
        )
    return X[idx_take], Y[idx_take]


def process_train_test(
    train_data: list[np.ndarray],
    train_labels: list[np.ndarray],
    test_data: list[np.ndarray] | None = None,
    test_labels: list[np.ndarray] | None = None,
    min_train_masks: int = 5,
    device="cuda",
):
    """Arrays → training samples (2D path).

    Input labels have 2 (instance + class) or 4 (instance + flows + class)
    channels; output per-sample labels are (5, H, W)
    [instance, class(−100-masked), binary, flow_y, flow_x] plus a diameter
    array. The flow targets are computed on ``device``.
    """

    def _process(data, labels, is_train):
        if data is None:
            return None, None, None
        for lab in labels:
            if lab.ndim != 3 or lab.shape[0] not in (2, 4):
                raise ValueError(
                    "labels must have 2 (instance+class) or 4 "
                    f"(instance+flows+class) channels, got {lab.shape}"
                )
        data, labels = filter_single_pixel_instances(data, labels)
        inst_labels, classes = split_labels(labels)
        diams = compute_diameter_array(inst_labels)
        out_labels = []
        for lab in inst_labels:
            flows = labels_to_flows(lab[0], device=device)
            out_labels.append(flows)  # [instance, binary, fy, fx]
        if is_train and min_train_masks > 0:
            data, out_labels, classes, diams = filter_min_train_masks(
                data, out_labels, classes, diams, min_train_masks
            )
        full = [
            np.concatenate(
                [fl[:1], cl.astype(np.float32), fl[1:]], axis=0
            )
            for fl, cl in zip(out_labels, classes)
        ]
        return data, full, diams

    train_data, train_full, train_diams = _process(
        train_data, train_labels, True
    )
    test_data, test_full, test_diams = _process(
        test_data, test_labels, False
    )
    return (
        train_data, train_full, train_diams,
        test_data, test_full, test_diams,
    )


def load_data_arrays(
    image_path: str, label_path: str
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """``images.npy`` / ``labels.npy`` → lists of per-sample arrays
    (object arrays of ragged samples too)."""
    images = np.load(image_path, allow_pickle=True)
    labels = np.load(label_path, allow_pickle=True)
    if images.dtype == object:
        images = list(images)
    else:
        images = [images[i] for i in range(len(images))]
    if labels.dtype == object:
        labels = list(labels)
    else:
        labels = [labels[i] for i in range(len(labels))]
    return images, labels
