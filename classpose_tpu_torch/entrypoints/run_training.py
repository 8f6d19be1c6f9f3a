"""Training CLI (counterpart of ``classpose_tpu/entrypoints/run_training.py``,
the ``classpose-train`` command), with the same flags and defaults:

    python -m classpose_tpu_torch.entrypoints.run_training \\
        --data_path DIR --output_dir models [--tiny_model] [--device cpu]

or data-parallel, one process per card:

    torchrun --nproc_per_node N -m \\
        classpose_tpu_torch.entrypoints.run_training --data_path DIR ...

Loads ``images.npy`` / ``labels.npy`` from ``--data_path`` and makes the
flow targets, or reads a ``.h5``/``.hdf5`` file that
``classpose-dataset-to-hdf5-torch`` (or the JAX package's
``classpose-dataset-to-hdf5``) wrote; splits train and validation,
optionally sparsifies or subsamples the npy labels, computes oversampling
probabilities and class weights, builds the model with its freeze
selection and runs ``train_class_seg``. ``--augmentation`` names a
StarDist augmentation config (``hed_only``, ``enhanced``) applied to each
item before the random rotate/resize. ``--device auto`` means CUDA.

Under ``torchrun`` each rank joins the process group (NCCL on cards, gloo
on the CPU) and takes card ``LOCAL_RANK`` of ``--device`` (``auto`` or
``cuda``: every visible card; a list ``cuda:2,3`` those cards);
``--batch_size`` is the global batch, split evenly over the ranks, and
each step is the update of the global batch. ``--lr_scaling sqrt``
multiplies the learning rate by √world there. Each rank draws its own
items' augmentation from its own stream, as in the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def main(args):
    """Train as ``args`` asks (a process group when ``WORLD_SIZE`` > 1);
    returns the final ``.npz``'s path."""
    from classpose_tpu_torch.parallel.distributed import (
        setup_distributed,
        teardown_distributed,
    )

    ctx = setup_distributed("cuda" if args.device == "auto" else args.device)
    try:
        return _train(args, ctx)
    finally:
        teardown_distributed()


def _train(args, ctx):
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.train.dataset import (
        ClassposeHDF5Dataset,
        ClassposeTrainingDataset,
    )
    from classpose_tpu_torch.train.train import train_class_seg
    from classpose_tpu_torch.train.train_utils import (
        compute_oversampling_probabilities,
        get_class_weights,
        load_data_arrays,
        process_train_test,
    )
    from classpose_tpu_torch.utils import make_sparse

    device = ctx.device
    rng = np.random.default_rng(args.seed)

    # ------------------------------------------------------------- dataset
    data_path = Path(args.data_path)
    if data_path.suffix in (".h5", ".hdf5"):
        full = ClassposeHDF5Dataset(
            str(data_path),
            augmentation_strategy=args.augmentation,
            bsize=args.bsize,
            seed=args.seed,
        )
        n = len(full)
        idx = rng.permutation(n)
        n_train = int(n * args.train_fraction)
        train_ds = full.subset(idx[:n_train])
        val_ds = full.subset(idx[n_train:]) if n_train < n else None
    else:
        images, labels = load_data_arrays(
            str(data_path / "images.npy"), str(data_path / "labels.npy"))
        if args.subsample_fraction:
            k = max(1, int(len(images) * args.subsample_fraction))
            sel = rng.choice(len(images), k, replace=False)
            images = [images[i] for i in sel]
            labels = [labels[i] for i in sel]
        if args.make_sparse:
            labels = [make_sparse(np.asarray(lab), 0.5, rng)
                      for lab in labels]
        tr_d, tr_l, tr_diam, *_ = process_train_test(
            images, labels, min_train_masks=args.min_train_masks,
            device=device)
        n = len(tr_d)
        idx = rng.permutation(n)
        n_train = max(1, int(n * args.train_fraction))

        def mk(sel):
            return ClassposeTrainingDataset(
                np.stack([tr_d[i] for i in sel]),
                np.stack([tr_l[i] for i in sel]),
                diameter_array=np.asarray([tr_diam[i] for i in sel]),
                augmentation_strategy=args.augmentation,
                bsize=args.bsize,
                seed=args.seed,
            )

        train_ds = mk(idx[:n_train])
        val_ds = mk(idx[n_train:]) if n_train < n else None

    n_classes = train_ds._resolve_n_classes()
    logger.info("dataset: %d train, %d classes", len(train_ds), n_classes)

    # ------------------------------------------------- sampling + weights
    train_probs = None
    if args.oversampling_method == "custom":
        train_probs = compute_oversampling_probabilities(
            train_ds.class_counts, train_ds.instance_counts,
            power=args.oversampling_power)
    class_weights = (None if args.no_class_weights
                     else get_class_weights(train_ds.class_counts))

    # --------------------------------------------------------------- model
    cfg = None
    if args.tiny_model:  # testing escape hatch
        cfg = ClassTransformerConfig(
            n_cell_classes=n_classes, embed_dim=32, depth=1, num_heads=2,
            neck_dim=16, bsize=args.bsize)
    model = ClassposeModel(pretrained_model=args.pretrained_model,
                           nclasses=n_classes, precision="fp32", cfg=cfg,
                           device=device)
    freeze = {}
    for f in args.freeze:
        if f == "backbone":
            freeze["backbone"] = True
        elif f == "neck":
            freeze["neck"] = True
        elif f in ("instance_classification", "seg"):
            freeze["instance_classification"] = True
    seg_trainable = not freeze.get("instance_classification", False)

    lr = args.learning_rate
    if args.lr_scaling == "sqrt" and ctx.world_size > 1:
        lr = lr * float(np.sqrt(ctx.world_size))

    config_snapshot = {k: (str(v) if isinstance(v, Path) else v)
                       for k, v in vars(args).items()}
    config_snapshot["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")

    path, _, _ = train_class_seg(
        model,
        train_ds,
        train_probs=train_probs,
        test_dataset=val_ds,
        batch_size=args.batch_size,
        learning_rate=lr,
        n_epochs=args.epochs,
        save_path=args.output_dir,
        save_every=args.save_every,
        save_each=args.save_each,
        model_name=args.model_name,
        class_weights=class_weights,
        use_uncertainty_weighting=not args.no_uncertainty_weighting,
        validate_every_epoch=args.validate_every_epoch,
        random_seed=args.seed,
        resume_checkpoint=args.resume_checkpoint,
        config_snapshot=config_snapshot,
        freeze=freeze,
        seg_trainable=seg_trainable,
    )
    logger.info("training complete: %s", path)
    return path


def build_parser():
    p = argparse.ArgumentParser(description="Train a Classpose model.")
    p.add_argument("--data_path", required=True,
                   help="Directory with images.npy/labels.npy or HDF5 file")
    p.add_argument("--train_fraction", type=float, default=0.9)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--lr_scaling", choices=["none", "sqrt"], default="none")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=str, default="models")
    p.add_argument("--make_sparse", action="store_true", default=False)
    p.add_argument("--subsample_fraction", type=float, default=None)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument(
        "--freeze", type=str, nargs="+", default=["none"],
        choices=["none", "backbone", "neck", "instance_classification",
                 "seg"],
    )
    p.add_argument("--oversampling_method",
                   choices=["none", "custom"], default="custom")
    p.add_argument("--n_rare_classes", type=int, default=4)
    p.add_argument("--oversampling_power", type=float, default=1.0)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--save_each", action="store_true", default=False)
    p.add_argument("--no_class_weights", action="store_true", default=False)
    p.add_argument("--no_uncertainty_weighting", action="store_true",
                   default=False)
    p.add_argument("--validate_every_epoch", action="store_true",
                   default=False)
    p.add_argument("--device", type=str, default="auto",
                   help="auto (= cuda), cuda, cuda:N, a list cuda:0,1 or "
                   "cpu; under torchrun rank r trains on entry LOCAL_RANK "
                   "of the list (cuda: every visible card), a process "
                   "alone on the first")
    p.add_argument("--resume_checkpoint", type=str, default=None)
    p.add_argument("--pretrained_model", type=str, default=None,
                   help="weights to start from: a published .pt or a "
                   "native .npz")
    p.add_argument("--min_train_masks", type=int, default=5)
    p.add_argument("--augmentation", type=str, default=None,
                   help="augmentation config name (hed_only/enhanced)")
    p.add_argument("--bsize", type=int, default=256)
    p.add_argument("--tiny_model", action="store_true", default=False,
                   help="tiny architecture for smoke tests")
    return p


def main_with_args(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main_with_args()
