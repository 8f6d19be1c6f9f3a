"""``classpose-calculate-metrics`` for the PyTorch / CUDA package (numpy
only: it needs no device).

    python -m classpose_tpu_torch.entrypoints.calculate_metrics \\
        --gt_path gt.npy --pred_path predictions.npy --output metrics.csv

Flag for flag the JAX CLI (reference calculate_metrics.py:39-213): loads
npy/npz masks (N × H × W × [instance, class]), applies an optional
``--label_map`` and ``--ignore_classes``, computes binary or multiclass
PQ, prints the tables and writes CSVs (the per-image table beside
``--output`` as ``<stem>_per_image.<ext>``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.metrics.pq import (
    compute_binary_pq_metrics,
    compute_multiclass_pq_metrics,
    format_rows,
    write_csv,
)
from classpose_tpu_torch.metrics.utils import load_masks

logger = get_logger(__name__)


def main(args) -> list[dict]:
    logger.info("Loading ground truth masks from %s", args.gt_path)
    gt_masks = load_masks(args.gt_path)
    logger.info("Loading predicted masks from %s", args.pred_path)
    pred_masks = load_masks(args.pred_path)

    nr_classes = (int(np.max([m[..., 1].max() for m in gt_masks]))
                  if not args.binary else 0)

    if args.label_map:
        logger.info("Applying label map: %s", args.label_map)
        label_map = {0: 0}
        unique_values = [0]
        for pair in args.label_map:
            k, v = pair.split("=")
            label_map[int(k)] = int(v)
            if int(v) not in unique_values:
                unique_values.append(int(v))
        unique_values = np.array(unique_values)
        lm = np.vectorize(label_map.get)
        for i in range(len(pred_masks)):
            pred_masks[i] = pred_masks[i].astype(int)
            pred_masks[i][..., 1] = lm(pred_masks[i][..., 1])
        for i in range(len(gt_masks)):
            gt_masks[i][..., 1] = np.where(
                np.isin(gt_masks[i][..., 1], unique_values),
                gt_masks[i][..., 1], 0)

    if args.ignore_classes:
        for c in args.ignore_classes:
            for masks in (gt_masks, pred_masks):
                for i in range(len(masks)):
                    m = masks[i]
                    m[..., 1][m[..., 1] == c] = 0

    if len(gt_masks) != len(pred_masks):
        raise ValueError(
            f"Number of ground truth masks ({len(gt_masks)}) doesn't match "
            f"predicted masks ({len(pred_masks)})")

    if args.binary:
        rows = compute_binary_pq_metrics(
            gt_masks, pred_masks, match_iou=args.match_iou,
            no_border_instances=args.no_border_instances)
        print("\nResults:")
        print(format_rows(rows))
        if args.output:
            Path(args.output).parent.mkdir(parents=True, exist_ok=True)
            write_csv(rows, args.output)
        return rows

    global_rows, per_image = compute_multiclass_pq_metrics(
        gt_masks, pred_masks, match_iou=args.match_iou,
        nr_classes=nr_classes, n_workers=args.n_workers,
        no_border_instances=args.no_border_instances)
    print("\nGlobal Results:")
    print(format_rows(global_rows))
    print("\nPer-Image Results:")
    print(format_rows(per_image[:5]))
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        write_csv(global_rows, args.output)
        base = args.output.rsplit(".", 1)[0]
        ext = args.output.rsplit(".", 1)[1] if "." in args.output else "csv"
        write_csv(per_image, f"{base}_per_image.{ext}")
    return global_rows


def main_with_args(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(
        description="Compute PQ (Panoptic Quality) metrics between ground "
        "truth and predicted masks.")
    parser.add_argument("--gt_path", required=True)
    parser.add_argument("--pred_path", required=True)
    parser.add_argument("--match_iou", type=float, default=0.5)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--ignore_classes", type=int, nargs="+",
                        default=None)
    parser.add_argument("--label_map", type=str, nargs="+", default=None)
    parser.add_argument("--no_border_instances", action="store_true",
                        default=False)
    parser.add_argument("--n_workers", type=int, default=1)
    return main(parser.parse_args(argv))


if __name__ == "__main__":
    main_with_args()
