"""``classpose-predict-wsi`` for the PyTorch / CUDA package.

    python -m classpose_tpu_torch.entrypoints.predict_wsi \\
        --model_config config.yaml --slide_path slide.svs \\
        --output_folder out [--device cpu] [--output_type csv spatialdata]

Flag for flag the JAX package's parser (same destinations, defaults,
choices and ``nargs``), which the QuPath extension drives. A built-in
``--model_config`` (``conic`` ...) loads its published
``$CLASSPOSE_MODEL_DIR/<name>.pt``; a YAML config may name a ``.pt`` or a
native ``.npz``. ``--device`` defaults to the first card; ``cpu`` runs on
the CPU. A ``.svs``/``.tif`` slide is read by the package's own TIFF reader
(the default, or ``WSI_READER=tiff``); a ``.npy`` slide takes
``WSI_READER=array``; a Zeiss ``.czi`` takes ``WSI_READER=czi`` (the
package's own reader: uncompressed, JpgFile, JpgXrFile, Zstd0 and Zstd1
subblocks). ``--tissue_detection_model_path`` and
``--artefact_detection_model_path`` take GrandQC ``.npz`` files
(``classpose-convert-weights-torch --kind grandqc``), run on the first
card. ``--device cuda:0,1`` (or ``cuda``, every visible card) runs the
tiles on several cards, one model copy each, as QuPath's "Device ids"
field asks; a card this machine lacks, a card named twice and
``cpu:0,1`` raise ``ValueError`` before any slide is read.
"""

from __future__ import annotations

import argparse

from classpose_tpu_torch.pipeline.predict_wsi import (
    build_model_from_config,
    check_supported,
    main,
)
from classpose_tpu_torch.pipeline.slide_loader import (
    DEFAULT_OVERLAP,
    DEFAULT_TILE_SIZE,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run Classpose WSI inference (PyTorch / CUDA)."
    )
    parser.add_argument(
        "--model_config", type=str, required=True,
        help="One of 'conic', 'consep', 'glysac', 'monusac', 'nucls', "
        "'puma' or a path to a Classpose model config YAML.",
    )
    parser.add_argument(
        "--slide_path", type=str, required=True, nargs="+",
        help="Path(s) (or HTTP/HTTPS URLs) of the whole-slide image(s); "
        "multiple slides share one model.",
    )
    parser.add_argument(
        "--tissue_detection_model_path", type=str, default=None,
        help="Path to the GrandQC tissue detection model weights "
        "(not ported yet: raises).",
    )
    parser.add_argument(
        "--artefact_detection_model_path", type=str, default=None,
        help="Path to the GrandQC artefact detection model weights "
        "(not ported yet: raises).",
    )
    parser.add_argument(
        "--filter_artefacts", action=argparse.BooleanOptionalAction,
        default=False,
        help="Filter cells detected in artefact regions.",
    )
    parser.add_argument(
        "--roi_geojson", type=str, default=None,
        help="FeatureCollection with (Multi)Polygon(s) in level-0 coords.",
    )
    parser.add_argument(
        "--roi_class_priority", type=str, default=None, nargs="+",
        help="ROI class names in priority order for overlapping regions.",
    )
    parser.add_argument(
        "--min_area", type=int, default=0,
        help="Minimum area of the tissue polygons.",
    )
    parser.add_argument(
        "--tta", action=argparse.BooleanOptionalAction, default=False,
        help="Test-time augmentation.",
    )
    parser.add_argument(
        "--batch_size", type=int, default=32,
        help="Net crops per forward chunk (32 runs a 1024² tile's 25-crop "
        "grid in one chunk).",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="'cuda' (every visible card), 'cuda:N', a list 'cuda:0,1' "
        "(tile-parallel: one model copy per card, whole --tile_batch "
        "batches dealt to the least busy card), 'gpu[:...]' alike, or "
        "'cpu'; unset, the first card.",
    )
    parser.add_argument(
        "--precision", type=str, default="bf16",
        choices=["fp32", "fp16", "bf16"],
        help="Inference precision ('fp16' runs as bf16).",
    )
    parser.add_argument("--tile_size", type=int, default=DEFAULT_TILE_SIZE)
    parser.add_argument("--overlap", type=int, default=DEFAULT_OVERLAP)
    parser.add_argument("--output_folder", type=str, required=True)
    parser.add_argument(
        "--output_type", type=str, default=None, nargs="+",
        choices=["csv", "spatialdata"],
    )
    parser.add_argument(
        "--inference_threads", type=int, default=None,
        help="Host post-processing threads.",
    )
    parser.add_argument(
        "--mpp", type=float, default=None,
        help="Override slide microns-per-pixel when metadata is missing.",
    )
    parser.add_argument(
        "--profile", type=str, default=None,
        help="Directory for a torch.profiler trace of the run.",
    )
    parser.add_argument(
        "--tile_batch", type=int, default=None,
        help="Slide tiles per eval_batch call, each on one card "
        "(default 8, whatever the number of cards).",
    )
    parser.add_argument(
        "--filter_background_tiles", action="store_true", default=False,
        help="Skip tiles failing the grey-histogram/blur/HED relevance "
        "heuristic.",
    )
    parser.add_argument(
        "--fast_qc", action="store_true", default=False,
        help="Half-resolution flow-QC and strided percentile stats.",
    )
    parser.add_argument(
        "--progress", action="store_true", default=None,
        help="Force the live progress line; auto-enabled on a TTY, or via "
        "CLASSPOSE_PROGRESS=1.",
    )
    return parser


def main_with_args(argv=None) -> list[dict]:
    """Parse ``argv``, check what waits, build the model once (on the
    first listed card; the pipeline copies it onto the others) and run
    every slide; returns each slide's summary."""
    from classpose_tpu_torch.model_configs import resolve_model_config
    from classpose_tpu_torch.utils import get_device

    args = build_parser().parse_args(argv)
    config = resolve_model_config(args.model_config)
    check_supported(args)
    config.download_if_necessary()
    model = build_model_from_config(
        config, precision=args.precision,
        n_config_labels=len(config.cell_types),
        device=get_device(args.device))
    results = []
    for slide in args.slide_path:
        args.slide_path = slide
        results.append(main(args, model_override=model))
    return results


if __name__ == "__main__":
    main_with_args()
