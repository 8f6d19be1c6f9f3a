"""Dataset-level PQ metrics, binary and CoNIC multiclass (counterpart of
``classpose_tpu/metrics/pq.py``).

Parity targets: reference metrics/pq.py — ``remove_border_instances``
(:65-92), ``compute_binary_pq_metrics`` (:95-156) and
``compute_multiclass_pq_metrics`` (:159-290), with dataset-level
TP/FP/FN aggregation. Where the JAX package returns pandas DataFrames,
these return rows (lists of dicts, one per DataFrame row, the same
columns); :func:`write_csv` and :func:`format_rows` stand in for
``to_csv`` and ``to_string``. ``n_workers ≥ 2`` runs a ``spawn`` pool: a
forked child of a process that holds a CUDA context cannot use it.
"""

from __future__ import annotations

import csv
import multiprocessing
import numbers

import numpy as np

from classpose_tpu_torch.metrics.stats_utils import get_multi_pq_info, get_pq
from classpose_tpu_torch.metrics.utils import (
    check_and_coherce_if_necessary,
    filter_out_unlabelled_cells,
    remap_label,
)


def remove_border_instances(mask: np.ndarray) -> np.ndarray:
    """Zero out instances with any pixel on the image border."""
    instances = mask[..., 0] if mask.ndim == 3 else mask
    border = np.unique(np.concatenate(
        [instances[0], instances[:, 0], instances[-1], instances[:, -1]]))
    border = border[border != 0]
    mask[np.isin(instances, border)] = 0
    return mask


def _detection(tp, fp, fn) -> dict:
    return {
        "precision": tp / (tp + fp) if tp + fp else 0.0,
        "recall": tp / (tp + fn) if tp + fn else 0.0,
        "f1": (2 * tp) / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0,
    }


def compute_binary_pq_metrics(gt_masks, pred_masks, match_iou: float = 0.5,
                              no_border_instances: bool = False
                              ) -> list[dict]:
    """Per-image binary PQ/DQ/SQ and detection P/R/F1, one row per image."""
    gt_masks = check_and_coherce_if_necessary(gt_masks, 2)
    pred_masks = check_and_coherce_if_necessary(pred_masks, 2)
    rows = []
    for i in range(len(gt_masks)):
        gt, pred = np.copy(gt_masks[i]), np.copy(pred_masks[i])
        if no_border_instances:
            gt = remove_border_instances(gt)
            pred = remove_border_instances(pred)
        gt, pred = remap_label(gt), remap_label(pred)
        (dq, sq, pq), (tp, fp, fn), iou_sum = get_pq(gt, pred,
                                                     match_iou=match_iou)
        rows.append({"image_id": i, "pq": pq, "dq": dq, "sq": sq,
                     "tp": tp, "fp": fp, "fn": fn, **_detection(tp, fp, fn),
                     "iou_sum": iou_sum,
                     "avg_iou": iou_sum / tp if tp > 0 else 0.0})
    return rows


class MulticlassPQCalculator:
    """Picklable per-image worker (reference pq.py:33-58)."""

    def __init__(self, nr_classes, match_iou, no_border_instances):
        self.nr_classes = nr_classes
        self.match_iou = match_iou
        self.no_border_instances = no_border_instances

    def __call__(self, args):
        gt, pred, idx = args
        if self.no_border_instances:
            gt = remove_border_instances(np.copy(gt))
            pred = remove_border_instances(np.copy(pred))
        return get_multi_pq_info(gt, pred, nr_classes=self.nr_classes,
                                 match_iou=self.match_iou), idx


def compute_multiclass_pq_metrics(gt_masks, pred_masks,
                                  match_iou: float = 0.5, nr_classes: int = 6,
                                  n_workers: int = 0,
                                  no_border_instances: bool = False
                                  ) -> tuple[list[dict], list[dict]]:
    """CoNIC-style dataset-level multiclass PQ. Returns (global rows: one
    per class and an ``avg`` row, per-image rows)."""
    gt_masks = check_and_coherce_if_necessary(gt_masks, 3)
    pred_masks = check_and_coherce_if_necessary(pred_masks, 3)
    gt_masks = [np.copy(m) for m in gt_masks]
    pred_masks = [np.copy(m) for m in pred_masks]
    gt_masks, pred_masks = filter_out_unlabelled_cells(gt_masks, pred_masks)

    tp_c, fp_c, fn_c, iou_c = (np.zeros(nr_classes) for _ in range(4))
    per_image = []
    calc = MulticlassPQCalculator(nr_classes, match_iou, no_border_instances)
    inputs = list(zip(gt_masks, pred_masks, range(len(gt_masks))))
    pool = None
    if n_workers < 2:
        mapped = map(calc, inputs)
    else:
        pool = multiprocessing.get_context("spawn").Pool(n_workers)
        mapped = pool.imap_unordered(calc, inputs)
    try:
        for pq_info, i in mapped:
            row = {"image_id": i}
            for c in range(nr_classes):
                tp, fp, fn, iou_sum = pq_info[c]
                tp_c[c] += tp
                fp_c[c] += fp
                fn_c[c] += fn
                iou_c[c] += iou_sum
                row[f"class_{c + 1}_tp"] = tp
                row[f"class_{c + 1}_fp"] = fp
                row[f"class_{c + 1}_fn"] = fn
                row[f"class_{c + 1}_avg_iou"] = (iou_sum / tp if tp > 0
                                                 else 0.0)
            per_image.append(row)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    per_image.sort(key=lambda r: r["image_id"])

    results = []
    for c in range(nr_classes):
        tp, fp, fn, iou_sum = tp_c[c], fp_c[c], fn_c[c], iou_c[c]
        dq = tp / ((tp + 0.5 * fp + 0.5 * fn) + 1.0e-6)
        sq = iou_sum / (tp + 1.0e-6)
        results.append({"class_id": c + 1, "pq": dq * sq, "dq": dq, "sq": sq,
                        "tp": tp, "fp": fp, "fn": fn,
                        **_detection(tp, fp, fn), "iou_sum": iou_sum})
    avg = {"class_id": "avg"}
    for k in ("pq", "dq", "sq", "tp", "fp", "fn", "precision", "recall",
              "f1", "iou_sum"):
        vals = [r[k] for r in results]
        summed = k in ("tp", "fp", "fn", "iou_sum")
        avg[k] = np.sum(vals) if summed else np.mean(vals)
    results.append(avg)
    return results, per_image


def _fmt(v) -> str:
    if isinstance(v, (bool, np.bool_)) or not isinstance(v, numbers.Number):
        return str(v)
    if isinstance(v, numbers.Integral):
        return str(int(v))
    return repr(float(v))


def _columns(rows: list[dict]) -> list[str]:
    cols: list[str] = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    return cols


def write_csv(rows: list[dict], path) -> None:
    """Rows to a CSV file with a header line (``DataFrame.to_csv(...,
    index=False)``'s layout; floats as their shortest repr)."""
    cols = _columns(rows)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for r in rows:
            w.writerow([_fmt(r[c]) if c in r else "" for c in cols])


def format_rows(rows: list[dict]) -> str:
    """Rows as a right-aligned text table (``to_string(index=False)``)."""
    cols = _columns(rows)

    def cell(v):
        if isinstance(v, numbers.Real) and not isinstance(
                v, (numbers.Integral, bool, np.bool_)):
            return f"{float(v):.6f}"
        return _fmt(v)

    table = [cols] + [[cell(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    return "\n".join(" ".join(v.rjust(w) for v, w in zip(row, widths))
                     for row in table)
