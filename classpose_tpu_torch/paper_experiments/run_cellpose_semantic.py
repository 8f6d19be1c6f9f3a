"""Semantic Cellpose-SAM baseline (counterpart of
``paper_experiments/run_cellpose_semantic.py``): a Cellpose-SAM
transformer whose class head is grafted from the cellprob readout of its
``out`` head (background −0.5 ×, each class +0.5 × those weights; bias
the cellprob bias), trained with ``train_class_seg`` at batch 4, lr 5e-5
and weight decay 0.1 with inverse-frequency class weights, then run over
a test set with ``ClassposeModel.eval``:

    python -m classpose_tpu_torch.paper_experiments.run_cellpose_semantic \\
        --train_data_path train_x.npy --train_labels_path train_y.npy \\
        --test_data_path test_x.npy --dataset_name lizard \\
        --out_path preds.npy [--skip_training] [--epochs 500] \\
        [--pretrained cpsam.pt] [--device cpu]

Flag for flag the JAX script, plus ``--device`` (``auto``, the default,
is the card). It writes the same files: the trainer's
``save_path/cellpose_<dataset>/cellpose_<dataset>.npz`` and
``checkpoint_last.train/``, and ``--out_path``, one (H, W, 2) [instance,
class] map per test image saved as ``np.array(preds, dtype="object")``.
``--training_to_inference_mpp "train:infer"`` rescales each test image
by ``infer / train`` with ``cv2.resize``'s ``INTER_LINEAR`` and the maps
back with ``INTER_NEAREST``, both copied bit for bit in
``transforms/cvlite.py``.

Where the JAX script's model differs:

- ``--pretrained`` a published ``.pt``: the JAX package keeps the
  script's config (``nclasses`` classes) and converts the file; this
  package's ``ClassposeModel`` would take the file's own class count, so
  the script builds the config itself and takes the backbone, neck and
  ``out`` from the file and the class head from the graft. A ``.pt``
  with no class head raises, as the JAX script does (its ``KeyError``).
- an ``.npz`` whose metadata gives another class count than the labels:
  the JAX script grafts a head its network cannot hold and fails at its
  first forward; this one raises at the graft. An ``.npz`` with a UNet
  class head keeps that head in both: the JAX graft writes a kernel the
  UNet never reads.
- no ``--pretrained``: the JAX package starts ViT-L from zeros, this one
  from ``ClassposeModel``'s seeded PyTorch init (the tiny model from each
  package's own init).
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from classpose_tpu_torch.transforms.cvlite import resize_linear, resize_nearest

logger = logging.getLogger(__name__)


def rescale_ratio(training_to_inference_mpp: str) -> float:
    """``"train_mpp:infer_mpp"`` → infer / train (1.0 when equal or
    empty); a plain number is the ratio itself."""
    if not training_to_inference_mpp:
        return 1.0
    if ":" in training_to_inference_mpp:
        t, i = training_to_inference_mpp.split(":")
        return float(i) / float(t) if float(t) != float(i) else 1.0
    return float(training_to_inference_mpp)


def rescale_if_necessary(image: np.ndarray, spec: str) -> np.ndarray:
    """The image at ``round(W / ratio) × round(H / ratio)``, linear."""
    ratio = rescale_ratio(spec)
    if ratio == 1.0:
        return image
    return resize_linear(image, int(round(image.shape[1] / ratio)),
                         int(round(image.shape[0] / ratio)))


def rescale_label_if_necessary(label: np.ndarray,
                               new_sh: tuple[int, int]) -> np.ndarray:
    """int32 ``label`` at ``new_sh`` (H, W), nearest."""
    if label.shape[:2] == tuple(new_sh):
        return label
    return resize_nearest(label.astype(np.int32), new_sh[1], new_sh[0])


def semantic_head(out_weight: torch.Tensor, out_bias: torch.Tensor,
                  nclasses: int, ps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The grafted 1×1 class head from the ``out`` head's (3·ps², C, 1, 1)
    weight and bias: the cellprob block is output channels 2·ps² … 3·ps²;
    class 0 (background) takes −0.5 × its weights, each other class
    +0.5 ×, every class its bias."""
    ps2 = ps * ps
    wc, bc = out_weight[2 * ps2:3 * ps2], out_bias[2 * ps2:3 * ps2]
    return (torch.cat([-0.5 * wc] + [0.5 * wc] * (nclasses - 1)),
            torch.cat([bc] * nclasses))


def build_semantic_model(nclasses: int, pretrained: str | None,
                         precision: str = "fp32", tiny: bool = False,
                         device: str | torch.device = "cuda"):
    """A ``ClassposeModel`` of ``nclasses`` classes (ViT-L, or the tiny
    test net) with its class head grafted from the cellprob readout. An
    ``.npz`` with metadata gives its own config, as in the JAX script."""
    from classpose_tpu_torch.nn.convert import load_checkpoint
    from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
    from classpose_tpu_torch.runner import ClassposeModel

    cfg = (ClassTransformerConfig(n_cell_classes=nclasses, embed_dim=32,
                                  depth=1, num_heads=2, neck_dim=16,
                                  bsize=64)
           if tiny else ClassTransformerConfig(n_cell_classes=nclasses))
    if pretrained is not None and not str(pretrained).endswith(".npz"):
        sd, _ = load_checkpoint(str(pretrained))
        if not any(k.startswith("out_class.") for k in sd):
            raise KeyError(
                f"{pretrained} has no class head (out_class.*): the "
                "semantic graft replaces one, as the JAX script does")
        sd = {k: v for k, v in sd.items() if not k.startswith("out_class.")}
        w, b = semantic_head(sd["out.weight"], sd["out.bias"], nclasses,
                             cfg.ps)
        return ClassposeModel(cfg=cfg, params={
            **sd, "out_class.weight": w, "out_class.bias": b},
            precision=precision, device=device)
    model = ClassposeModel(cfg=cfg, pretrained_model=pretrained,
                           precision=precision, device=device)
    net = model.net
    if model.nclasses != nclasses:
        raise ValueError(
            f"{pretrained} holds a model of {model.nclasses} classes; the "
            f"labels need {nclasses}")
    if model.cfg.feature_transformation_structure is not None:
        # the JAX graft writes a 1×1 kernel beside the UNet's blocks,
        # which the UNet never reads: the head trains as loaded
        logger.warning("%s has a UNet class head: no graft", pretrained)
        return model
    w, b = semantic_head(net.out.weight, net.out.bias, nclasses,
                         model.cfg.ps)
    with torch.no_grad():
        net.out_class.weight.copy_(w)
        net.out_class.bias.copy_(b)
    return model


def predict(model, test_data, spec: str) -> list[np.ndarray]:
    """One (H, W, 2) [instance, class] map per test image: the image
    rescaled by ``spec``, ``model.eval`` as the paper ran it, the maps
    rescaled back to the image's size."""
    preds = []
    for x in test_data:
        xr = rescale_if_necessary(np.asarray(x), spec)
        masks, _flows, class_masks, _ = model.eval(
            xr.astype(np.float32), batch_size=64, augment=False,
            flow_threshold=0.4, cellprob_threshold=0.0)
        out = np.stack([masks, class_masks], axis=-1)
        preds.append(
            rescale_label_if_necessary(out, np.asarray(x).shape[:2]))
    return preds


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Semantic Cellpose-SAM baseline (PyTorch / CUDA).")
    p.add_argument("--train_data_path", type=str, default="")
    p.add_argument("--train_labels_path", type=str, default="")
    p.add_argument("--test_data_path", type=str, default="")
    p.add_argument("--dataset_name", type=str, default="")
    p.add_argument("--out_path", type=str, default="preds.npy")
    p.add_argument("--training_to_inference_mpp", type=str, default="")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--pretrained", type=str, default=None,
                   help="cpsam checkpoint (.pt or converted .npz)")
    p.add_argument("--save_path", type=str, default="models")
    p.add_argument("--precision", type=str, default="fp32")
    p.add_argument("--tiny_model", action="store_true",
                   help="tiny architecture (testing escape hatch)")
    p.add_argument("--device", type=str, default="auto",
                   help="auto (= cuda), cuda, cuda:N or cpu")
    return p


def main(argv=None) -> dict:
    """Train (unless ``--skip_training``) and predict as the flags ask.
    Returns ``dict(model_path, out_path, train_s, train_images, eval_s,
    eval_images)`` and, after training, ``step_ends``: the seconds from
    the trainer's start to the end of each step (its losses read back)."""
    from classpose_tpu_torch.runner import ClassposeModel
    from classpose_tpu_torch.train.dataset import ClassposeTrainingDataset
    from classpose_tpu_torch.train.train import train_class_seg
    from classpose_tpu_torch.train.train_utils import (
        get_class_weights,
        process_train_test,
    )
    from classpose_tpu_torch.utils import get_device

    args = build_parser().parse_args(argv)
    device = get_device("cuda" if args.device == "auto" else args.device)
    train_data = np.load(args.train_data_path, allow_pickle=True)
    train_labels = np.load(args.train_labels_path, allow_pickle=True)
    test_data = np.load(args.test_data_path, allow_pickle=True)
    train_labels = [np.asarray(x).astype(int) for x in train_labels]
    # labels are (H, W, 2) [instance, class], class 0 the background
    nclasses = int(max(x[..., 1].max() for x in train_labels)) + 1

    model_name = f"cellpose_{args.dataset_name}"
    model_path = os.path.join(args.save_path, model_name,
                              f"{model_name}.npz")

    stats = dict(model_path=model_path, out_path=args.out_path, train_s=0.0,
                 train_images=0)
    if not args.skip_training:
        model = build_semantic_model(nclasses, args.pretrained,
                                     args.precision, tiny=args.tiny_model,
                                     device=device)
        labels_ic = [np.stack([x[..., 0], x[..., 1]]) for x in train_labels]
        imgs = [np.transpose(np.asarray(x), (2, 0, 1)) for x in train_data]
        tr_d, tr_l, tr_diam, *_ = process_train_test(
            imgs, labels_ic, min_train_masks=0, device=device)
        ds = ClassposeTrainingDataset(
            np.stack(tr_d), np.stack(tr_l),
            diameter_array=np.asarray(tr_diam), bsize=model.cfg.bsize)
        class_weights = get_class_weights(ds.class_counts)
        step_ends = []
        t0 = time.perf_counter()
        train_class_seg(
            model, ds, batch_size=4, n_epochs=args.epochs,
            learning_rate=5e-5, weight_decay=0.1,
            class_weights=class_weights, save_path=args.save_path,
            model_name=model_name,
            on_step=lambda step, m: step_ends.append(time.perf_counter()))
        stats.update(train_s=time.perf_counter() - t0,
                     train_images=4 * len(step_ends),
                     step_ends=[t - t0 for t in step_ends])
        del model

    # .npz checkpoints carry their config
    model = ClassposeModel(pretrained_model=model_path,
                           precision=args.precision, device=device)
    t0 = time.perf_counter()
    preds = predict(model, test_data, args.training_to_inference_mpp)
    stats.update(eval_s=time.perf_counter() - t0, eval_images=len(preds))

    d = os.path.dirname(args.out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.save(args.out_path, np.array(preds, dtype="object"))
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
