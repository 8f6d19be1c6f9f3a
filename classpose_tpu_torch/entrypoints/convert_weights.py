"""``classpose-convert-weights-torch``: a published torch checkpoint →
the native ``.npz`` (counterpart of the JAX package's
``classpose-convert-weights``, classpose kind).

    python -m classpose_tpu_torch.entrypoints.convert_weights \\
        --input conic.pt --output conic.npz

The architecture is inferred from the tensor shapes and written into the
``.npz``'s ``__meta__``, so the file describes itself; the JAX package
and this one load it alike. ``--kind grandqc`` waits for the GrandQC
models (``ROADMAP.md`` queue 1) and raises.
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

    if args.kind != "classpose":
        from classpose_tpu_torch.pipeline.predict_wsi import GRANDQC_ITEM

        raise NotImplementedError(
            f"--kind {args.kind}: GrandQC checkpoints wait for "
            f"{GRANDQC_ITEM}")
    sd = load_torch_checkpoint(args.input)
    cfg = infer_config_from_state_dict(sd)
    logger.info("inferred config: %s", cfg)
    save_params(state_dict_from_published(sd), args.output, cfg)
    logger.info("wrote %s", args.output)


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
