"""``classpose-predict-wsi-cpsam-torch``: the WSI pipeline for a vanilla
single-class Cellpose-SAM model (no class head), counterpart of the JAX
package's ``classpose-predict-wsi-cpsam``.

    python -m classpose_tpu_torch.entrypoints.predict_wsi_cpsam \\
        --model_path cpsam.pt --slide_path slide.svs --output_folder out

The same slide loader, post-processing and GeoJSON output as
``classpose-predict-wsi-torch``, with the model read from
``--model_path`` (a published ``.pt`` or a native ``.npz``) at
``--train_mpp``; every cell gets the label "cell" (color [0, 168, 132]).
Slides are read as ``WSI_READER`` selects (``.svs``/``.tif`` by default,
``.npy`` with ``WSI_READER=array``).
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

from classpose_tpu_torch.model_configs import ModelConfig
from classpose_tpu_torch.pipeline.predict_wsi import main as _pipeline_main
from classpose_tpu_torch.pipeline.slide_loader import (
    DEFAULT_OVERLAP,
    DEFAULT_TILE_SIZE,
)


def main(args, model_override=None) -> dict:
    """Run the pipeline on ``args.slide_path`` with the single-class model
    of ``args.model_path`` (or ``model_override``)."""
    if model_override is None and not str(args.model_path).endswith(
            (".npz", ".pt")):
        raise ValueError("--model_path must point to a .npz or .pt checkpoint")
    cfg = ModelConfig(path=args.model_path, mpp=args.train_mpp,
                      cell_types=["cell"])
    return _pipeline_main(SimpleNamespace(**{**vars(args),
                                             "model_config": cfg}),
                          model_override=model_override)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run vanilla CellposeSAM WSI inference (single class, "
        "PyTorch / CUDA)."
    )
    parser.add_argument("--model_path", type=str, required=True,
                        help="Path to the CellposeSAM weights (.npz/.pt).")
    parser.add_argument("--train_mpp", type=float, default=0.5,
                        help="MPP the model was trained at.")
    parser.add_argument("--slide_path", type=str, required=True)
    parser.add_argument("--tissue_detection_model_path", type=str,
                        default=None)
    parser.add_argument("--artefact_detection_model_path", type=str,
                        default=None)
    parser.add_argument("--filter_artefacts",
                        action=argparse.BooleanOptionalAction, default=False)
    parser.add_argument("--roi_geojson", type=str, default=None)
    parser.add_argument("--min_area", type=int, default=0)
    parser.add_argument("--tta", action=argparse.BooleanOptionalAction,
                        default=False)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default=None,
                        help="'cuda' (every visible card), 'cuda:N', a "
                        "list 'cuda:0,1' (tile-parallel: one model copy "
                        "per card, whole --tile_batch batches dealt to the "
                        "least busy card), 'gpu[:...]' alike, or 'cpu'; "
                        "unset, the first card.")
    parser.add_argument("--precision", type=str, default="bf16",
                        choices=["fp32", "fp16", "bf16"])
    parser.add_argument("--tile_size", type=int, default=DEFAULT_TILE_SIZE)
    parser.add_argument("--overlap", type=int, default=DEFAULT_OVERLAP)
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument("--output_type", type=str, default=None, nargs="+",
                        choices=["csv", "spatialdata"])
    parser.add_argument("--inference_threads", type=int, default=None)
    parser.add_argument("--mpp", type=float, default=None)
    parser.add_argument("--tile_batch", type=int, default=1)
    parser.add_argument("--fast_qc", action="store_true", default=False)
    parser.add_argument("--filter_background_tiles", action="store_true",
                        default=False)
    parser.add_argument("--profile", type=str, default=None)
    parser.add_argument("--roi_class_priority", type=str, default=None,
                        nargs="+")
    return parser


def main_with_args(argv=None) -> dict:
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    main_with_args()
