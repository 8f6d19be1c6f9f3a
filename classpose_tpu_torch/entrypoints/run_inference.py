"""``classpose-evaluate`` for the PyTorch / CUDA package: per-image
inference over a dataset, then CoNIC multiclass PQ against its labels.

    python -m classpose_tpu_torch.entrypoints.run_inference \\
        --data_path DIR --model_path model.pt --output_dir OUT \\
        [--device cpu] [--precision fp32]

``DIR`` holds ``images.npy`` (N images, HWC or CHW) and ``labels.npy``
(N × [instance, ..., class] maps). Every image goes through
``ClassposeModel.eval``; the masks and class maps are saved stacked as
``predictions.npy`` (N, H, W, 2), so the images must share one size, as in
the JAX CLI. The metrics go to ``metrics.csv`` and
``metrics_per_image.csv`` and the global table is printed. Flag for flag
the JAX ``classpose-evaluate``, plus ``--device`` (the card unless
``cpu``).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from classpose_tpu_torch.log import get_logger

logger = get_logger(__name__)


def main(args) -> dict:
    """Returns ``dict(metrics=global rows, per_image=rows, n_images,
    inference_s, metrics_s)``."""
    from classpose_tpu_torch.metrics.pq import (
        compute_multiclass_pq_metrics,
        format_rows,
        write_csv,
    )
    from classpose_tpu_torch.nn.convert import infer_structure
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.train.train_utils import load_data_arrays
    from classpose_tpu_torch.utils import get_device

    images, labels = load_data_arrays(
        str(Path(args.data_path) / "images.npy"),
        str(Path(args.data_path) / "labels.npy"))
    if args.max_images:
        images = images[:args.max_images]
        labels = labels[:args.max_images]

    # a .pt (or an .npz with __meta__) gives its model the config of its
    # own tensors; an .npz without __meta__ needs the head from its keys
    structure, n_classes = (infer_structure(args.model_path)
                            if str(args.model_path).endswith(".npz")
                            else (None, None))
    model = ClassposeModel(pretrained_model=args.model_path,
                           nclasses=n_classes,
                           feature_transformation_structure=structure,
                           precision=args.precision,
                           device=get_device(args.device))
    n_classes = model.nclasses

    preds = []
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        x = np.asarray(img, np.float32)
        if x.ndim == 3 and x.shape[0] in (1, 3):
            x = x.transpose(1, 2, 0)
        masks, _, class_masks, _ = model.eval(
            x, batch_size=args.batch_size,
            flow_threshold=args.flow_threshold,
            cellprob_threshold=args.cellprob_threshold)
        preds.append(np.stack([masks, class_masks], axis=-1))
        if (i + 1) % 10 == 0:
            logger.info("inference %d/%d (%.2f s/img)", i + 1, len(images),
                        (time.perf_counter() - t0) / (i + 1))
    inference_s = time.perf_counter() - t0

    gts = [np.stack([np.asarray(lab[0]), np.asarray(lab[-1])],
                    axis=-1).astype(np.int32) for lab in labels]
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "predictions.npy", np.stack(preds).astype(np.int32))

    t0 = time.perf_counter()
    global_rows, per_image = compute_multiclass_pq_metrics(
        gts, preds,
        nr_classes=n_classes - 1 if args.background_class else n_classes,
        no_border_instances=args.no_border_instances)
    metrics_s = time.perf_counter() - t0
    write_csv(global_rows, out / "metrics.csv")
    write_csv(per_image, out / "metrics_per_image.csv")
    print(format_rows(global_rows))
    return dict(metrics=global_rows, per_image=per_image,
                n_images=len(preds), inference_s=inference_s,
                metrics_s=metrics_s)


def main_with_args(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Batch inference + multiclass PQ evaluation "
        "(PyTorch / CUDA).")
    p.add_argument("--data_path", required=True,
                   help="Directory with images.npy and labels.npy")
    p.add_argument("--model_path", required=True)
    p.add_argument("--output_dir", default="inference_out")
    p.add_argument("--precision", default="fp32",
                   choices=["fp32", "fp16", "bf16"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--flow_threshold", type=float, default=0.4)
    p.add_argument("--cellprob_threshold", type=float, default=0.0)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--no_border_instances", action="store_true",
                   default=False)
    p.add_argument("--background_class", action="store_true", default=False,
                   help="model's class 0 is background (exclude from PQ)")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    return main(p.parse_args(argv))


if __name__ == "__main__":
    main_with_args()
