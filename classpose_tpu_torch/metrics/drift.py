"""(The port's own copy of ``classpose_tpu/metrics/drift.py``, numpy
only.) Precision-drift audit: compare two runs of the segmentation pipeline
(e.g. bf16 vs fp32) at the INSTANCE level — detection F1 via IoU>0.5
pairing, per-cell class agreement on matched pairs, and mask-count delta.

The WSI pipeline runs bf16 (reference default, models.py:37-69) while
numeric parity is held at fp32; this module says what bf16 changes at
the instance level."""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.metrics.stats_utils import get_pq
from classpose_tpu_torch.metrics.utils import pairwise_iou_matrix, remap_label


def _instance_class(masks: np.ndarray, cm: np.ndarray, n: int):
    """Majority (constant) class value per instance id 1..n."""
    out = np.zeros(n + 1, np.int32)
    flat_m = masks.ravel()
    flat_c = cm.ravel()
    fg = flat_m > 0
    # class maps are per-instance constant (majority vote) — the first
    # occurrence of each id carries the class
    ids, first = np.unique(flat_m[fg], return_index=True)
    out[ids] = flat_c[fg][first]
    return out


def detection_class_agreement(
    masks_a: np.ndarray,
    masks_b: np.ndarray,
    cm_a: np.ndarray | None = None,
    cm_b: np.ndarray | None = None,
    match_iou: float = 0.5,
) -> dict:
    """Instance-level agreement between two mask (+class) maps.

    Returns {n_a, n_b, tp, f1, mean_matched_iou, class_agreement,
    count_delta_frac}; class_agreement is None without class maps."""
    a = remap_label(np.asarray(masks_a).astype(np.int32))
    b = remap_label(np.asarray(masks_b).astype(np.int32))
    n_a, n_b = int(a.max()), int(b.max())
    if n_a == 0 and n_b == 0:
        return {
            "n_a": 0, "n_b": 0, "tp": 0, "f1": 1.0,
            "mean_matched_iou": 1.0, "class_agreement": None,
            "count_delta_frac": 0.0,
        }
    (_, sq, _), (tp, fp, fn), _ = get_pq(a, b, match_iou=match_iou)
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)

    class_agreement = None
    if cm_a is not None and cm_b is not None and tp > 0:
        iou = pairwise_iou_matrix(a, b)
        masked = np.where(iou > match_iou, iou, 0.0)
        pa, pb = np.nonzero(masked)
        ca = _instance_class(a, np.asarray(cm_a), n_a)
        cb = _instance_class(b, np.asarray(cm_b), n_b)
        class_agreement = float(
            np.mean(ca[pa + 1] == cb[pb + 1])
        )
    return {
        "n_a": n_a,
        "n_b": n_b,
        "tp": int(tp),
        "f1": float(f1),
        "mean_matched_iou": float(sq),
        "class_agreement": class_agreement,
        "count_delta_frac": abs(n_a - n_b) / max(n_a, 1),
    }


def aggregate_agreement(per_tile: list[dict]) -> dict:
    """Dataset-level aggregation (CoNIC-style: sum TP/FP/FN over tiles)."""
    n_a = sum(d["n_a"] for d in per_tile)
    n_b = sum(d["n_b"] for d in per_tile)
    tp = sum(d["tp"] for d in per_tile)
    fp = n_b - tp
    fn = n_a - tp
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    cls = [d["class_agreement"] for d in per_tile
           if d["class_agreement"] is not None and d["tp"] > 0]
    weights = [d["tp"] for d in per_tile
               if d["class_agreement"] is not None and d["tp"] > 0]
    return {
        "n_tiles": len(per_tile),
        "n_a": n_a,
        "n_b": n_b,
        "detection_f1": float(f1),
        "class_agreement": (
            float(np.average(cls, weights=weights)) if cls else None
        ),
        "count_delta_frac": abs(n_a - n_b) / max(n_a, 1),
    }
