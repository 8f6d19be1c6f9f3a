"""``classpose-convert-weights-torch``: a published torch checkpoint →
the native ``.npz`` (counterpart of the JAX package's
``classpose-convert-weights``).

    python -m classpose_tpu_torch.entrypoints.convert_weights \\
        --input conic.pt --output conic.npz
    python -m classpose_tpu_torch.entrypoints.convert_weights \\
        --input grandqc_tissue.pt --output tissue.npz --kind grandqc

A classpose checkpoint's architecture is inferred from the tensor shapes
and written into the ``.npz``'s ``__meta__``, so the file describes
itself. A GrandQC checkpoint (smp UnetPlusPlus on timm-efficientnet-b0)
takes its class count from ``segmentation_head.*.weight`` (else
``--classes``), is diffed against the published key/shape manifest, and
is grafted (``--strict`` refuses a tensor left over). The JAX package and
this one load either ``.npz`` alike.
"""

from __future__ import annotations

import argparse

from classpose_tpu_torch.log import get_logger

logger = get_logger(__name__)


def main(args) -> None:
    from classpose_tpu_torch.nn.convert import (
        infer_config_from_state_dict,
        load_torch_checkpoint,
        save_params,
        state_dict_from_published,
    )

    sd = load_torch_checkpoint(args.input)
    if args.kind == "classpose":
        cfg = infer_config_from_state_dict(sd)
        logger.info("inferred config: %s", cfg)
        save_params(state_dict_from_published(sd), args.output, cfg)
    else:
        _convert_grandqc(sd, args)
    logger.info("wrote %s", args.output)


def _convert_grandqc(sd, args) -> None:
    from classpose_tpu_torch.grandqc.convert import (
        convert_grandqc_checkpoint,
        save_grandqc_npz,
    )
    from classpose_tpu_torch.grandqc.nets import UnetPlusPlusConfig
    from classpose_tpu_torch.nn.manifest import (
        grandqc_manifest,
        manifest_diff,
    )

    head_key = next((k for k in sd if k.startswith("segmentation_head")
                     and k.endswith("weight")), None)
    classes = (int(sd[head_key].shape[0]) if head_key is not None
               else args.classes)
    logger.info("segmentation classes: %d", classes)
    d = manifest_diff(sd, grandqc_manifest(classes))
    if d["match"]:
        logger.info("checkpoint matches the Zenodo key/shape manifest")
    else:
        logger.warning(
            "checkpoint deviates from the Zenodo manifest: %d missing, %d "
            "unexpected, %d shape mismatches — %s", len(d["missing"]),
            len(d["unexpected"]), len(d["shape_mismatch"]),
            (d["missing"] + d["unexpected"])[:5])
    params, frac = convert_grandqc_checkpoint(sd, classes=classes,
                                              strict=args.strict)
    save_grandqc_npz(params, args.output, UnetPlusPlusConfig(classes=classes))
    logger.info("grafted fraction: %.2f", frac)


def main_with_args(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Convert torch checkpoints to native .npz weights."
    )
    p.add_argument("--input", required=True, help="torch .pt checkpoint")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--kind", choices=["classpose", "grandqc"],
                   default="classpose")
    p.add_argument("--classes", type=int, default=2,
                   help="segmentation classes fallback when the grandqc "
                   "checkpoint has no segmentation_head tensor")
    p.add_argument("--strict", action="store_true", default=False)
    main(p.parse_args(argv))


if __name__ == "__main__":
    main_with_args()
