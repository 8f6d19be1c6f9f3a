"""Panoptic-quality statistics (counterpart of
``classpose_tpu/metrics/stats_utils.py``; numpy and scipy only).

Parity targets: reference metrics/stats_utils.py — ``get_pq`` (:64-178,
pairwise IoU + unique >0.5 pairing or Munkres below 0.5),
``get_multi_pq_info`` (:8-61, per-class [tp, fp, fn, iou_sum]) and
``get_multi_r2`` (:181-217), whose R² is computed here with numpy as
sklearn's ``r2_score`` computes it.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from classpose_tpu_torch.metrics.utils import pairwise_iou_matrix, remap_label


def get_pq(true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5):
    """Returns ([dq, sq, pq], [tp, fp, fn], paired_iou_sum)."""
    assert match_iou >= 0.0, "Can't be negative"
    true = remap_label(true).astype(np.int32)
    pred = remap_label(pred).astype(np.int32)
    n_true, n_pred = int(true.max()), int(pred.max())
    pairwise_iou = pairwise_iou_matrix(true, pred)

    if match_iou > 0.0:
        masked = np.where(pairwise_iou > match_iou, pairwise_iou, 0.0)
        paired_true, paired_pred = np.nonzero(masked)
        paired_iou = masked[paired_true, paired_pred]
    else:
        paired_true, paired_pred = linear_sum_assignment(-pairwise_iou)
        paired_iou = pairwise_iou[paired_true, paired_pred]
        keep = paired_iou > match_iou
        paired_true = paired_true[keep]
        paired_pred = paired_pred[keep]
        paired_iou = paired_iou[keep]

    tp = len(paired_true)
    fp = n_pred - len(np.unique(paired_pred))
    fn = n_true - len(np.unique(paired_true))
    dq = tp / ((tp + 0.5 * fp + 0.5 * fn) + 1.0e-6)
    sq = paired_iou.sum() / (tp + 1.0e-6)
    return [dq, sq, dq * sq], [tp, fp, fn], paired_iou.sum()


def get_multi_pq_info(true: np.ndarray, pred: np.ndarray,
                      nr_classes: int = 6, match_iou: float = 0.5):
    """Per-class [tp, fp, fn, iou_sum] for CoNIC dataset-level PQ;
    ``true``/``pred`` are H×W×2 [instance, class]."""
    assert match_iou >= 0.0
    true_inst, true_class = true[..., 0], true[..., 1]
    pred_inst, pred_class = pred[..., 0], pred[..., 1]
    out = []
    for idx in range(nr_classes):
        p_one = remap_label(pred_inst * (pred_class == idx + 1))
        t_one = remap_label(true_inst * (true_class == idx + 1))
        _, counts, iou_sum = get_pq(t_one, p_one, match_iou=match_iou)
        out.append([counts[0], counts[1], counts[2], iou_sum])
    return out


CONIC_CLASS_NAMES = [
    "epithelial", "lymphocyte", "plasma", "neutrophil", "eosinophil",
    "connective",
]


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination 1 − SS_res/SS_tot, as sklearn's
    ``r2_score`` gives it for one output (1.0 for a perfect fit of a
    constant target, 0.0 for an imperfect one)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def _columns(table) -> dict:
    """Column name → values, from a mapping of columns or a list of row
    dicts."""
    if isinstance(table, (list, tuple)):
        return {k: [r[k] for r in table] for k in (table[0] if table else {})}
    return {k: list(v) for k, v in dict(table).items()}


def get_multi_r2(true, pred, class_names: list[str] | None = None) -> float:
    """Average per-class R² of nuclei counts (CoNIC regression metric);
    ``true``/``pred`` are mappings of class name → counts per image, or
    lists of row dicts."""
    class_names = class_names or CONIC_CLASS_NAMES
    true, pred = _columns(true), _columns(pred)
    for col in list(true) + list(pred):
        if col not in class_names:
            raise ValueError(f"{col} column header not recognised")
    return float(np.mean([r2_score(true[c], pred[c]) for c in class_names]))
