"""Metric utilities: label remapping, bounding boxes, sparse-GT filtering
(the port's own copy of ``classpose_tpu/metrics/utils.py``, numpy only).

Parity targets: reference metrics/utils.py — ``remap_label`` (:11-25,
fastremap there, pure numpy here), ``get_bounding_box`` (:76-95),
``check_and_coherce_if_necessary`` (:132-160), and
``filter_out_unlabelled_cells`` (:162-252) which removes GT instances
without class labels AND their matched predictions so sparse ground truth
doesn't count model detections as false positives.
"""

from __future__ import annotations

import numpy as np


def remap_label(arr: np.ndarray) -> np.ndarray:
    """Renumber instance ids to contiguous 1..N (order of first appearance
    in sorted id order), background 0 preserved."""
    arr = np.asarray(arr)
    ids = np.unique(arr)
    lookup = np.zeros(int(ids.max()) + 1 if ids.size and ids.max() >= 0
                      else 1, dtype=arr.dtype)
    next_id = 1
    for i in ids:
        if i == 0:
            continue
        lookup[int(i)] = next_id
        next_id += 1
    return lookup[arr.astype(np.int64)]


def get_bounding_box(img: np.ndarray) -> list[int]:
    """[rmin, rmax, cmin, cmax] with exclusive max (reference
    metrics/utils.py:76-95)."""
    rows = np.any(img, axis=1)
    cols = np.any(img, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [int(rmin), int(rmax) + 1, int(cmin), int(cmax) + 1]


def check_and_coherce_if_necessary(masks, expected_shape_length: int):
    if isinstance(masks, list):
        return masks
    if len(masks.shape) == expected_shape_length:
        masks = masks[None]
    elif len(masks.shape) != (expected_shape_length + 1):
        raise ValueError(
            f"Masks have {len(masks.shape)} dimensions, expected "
            f"{expected_shape_length}"
        )
    return masks


def pairwise_iou_matrix(
    true: np.ndarray, pred: np.ndarray
) -> np.ndarray:
    """Dense (n_true, n_pred) IoU matrix via one contingency bincount —
    O(H·W) instead of the reference's per-instance crop loops
    (stats_utils.py:106-136), with identical values."""
    true = true.astype(np.int64).ravel()
    pred = pred.astype(np.int64).ravel()
    nt, npred = int(true.max()), int(pred.max())
    if nt == 0 or npred == 0:
        return np.zeros((nt, npred))
    inter = np.bincount(
        true * (npred + 1) + pred, minlength=(nt + 1) * (npred + 1)
    ).reshape(nt + 1, npred + 1)[1:, 1:]
    area_t = np.bincount(true, minlength=nt + 1)[1:]
    area_p = np.bincount(pred, minlength=npred + 1)[1:]
    union = area_t[:, None] + area_p[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def filter_out_unlabelled_cells(
    gt_masks, pred_masks, min_iou: float = 0.5
):
    """Remove unlabelled GT instances (class channel 0) and their IoU>0.5
    matched predictions (reference metrics/utils.py:162-252)."""
    for i in range(len(gt_masks)):
        gt_mask, pred_mask = gt_masks[i], pred_masks[i]
        gt_instances = remap_label(gt_mask[..., 0])
        pred_instances = remap_label(pred_mask[..., 0])
        gt_max, pred_max = int(gt_instances.max()), int(pred_instances.max())
        if gt_max <= 0 or pred_max <= 0:
            continue
        labelled = np.unique(gt_instances * (gt_mask[..., 1] > 0))
        labelled = set(labelled[labelled > 0].tolist())
        if len(labelled) == gt_max:
            continue
        iou = pairwise_iou_matrix(gt_instances, pred_instances)
        remove_gt, remove_pred = [], []
        for gt_id in range(1, gt_max + 1):
            if gt_id in labelled:
                continue
            matched = np.nonzero(iou[gt_id - 1] > min_iou)[0]
            if matched.size:
                # unlabelled GT cell + its matched prediction both removed;
                # unmatched unlabelled GT stays (reference behavior,
                # metrics/utils.py:234-238)
                remove_pred.extend((matched + 1).tolist())
                remove_gt.append(gt_id)
        gt_mask[np.isin(gt_instances, np.unique(remove_gt))] = 0
        pred_mask[np.isin(pred_instances, np.unique(remove_pred))] = 0
        gt_mask[..., 0] = remap_label(gt_mask[..., 0])
        pred_mask[..., 0] = remap_label(pred_mask[..., 0])
        gt_masks[i] = gt_mask
        pred_masks[i] = pred_mask
    return gt_masks, pred_masks


def load_masks(path: str) -> np.ndarray:
    """Load masks from .npy / .npz (reference metrics/utils.py:97-130)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            key = list(z.files)[0]
            return z[key]
    return np.load(path, allow_pickle=True)
