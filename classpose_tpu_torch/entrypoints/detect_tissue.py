"""``classpose-detect-tissue-torch``: GrandQC tissue detection
(counterpart of the JAX package's ``classpose-detect-tissue``, which the
QuPath tissue action drives).

    python -m classpose_tpu_torch.entrypoints.detect_tissue \\
        --slide_path slide.svs --model_path tissue.npz --output_folder out

Writes ``{base}_tissue_contours.geojson`` into the output folder. The net
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from classpose_tpu_torch.grandqc import detect_tissue_wsi
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.utils import get_device, get_geojson_output_filename

logger = get_logger(__name__)


def main(args):
    res = detect_tissue_wsi(args.slide_path, model_path=args.model_path,
                            min_area=args.min_area,
                            device=get_device(getattr(args, "device", None)))
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    base = Path(args.slide_path).name.rsplit(".", 1)[0]
    path = out / get_geojson_output_filename("tissue_contours", base)
    path.write_text(json.dumps(res["geojson"]))
    logger.info("wrote %s (%d regions)", path, len(res["polygons"]))
    return res


def main_with_args(argv=None):
    p = argparse.ArgumentParser(description="GrandQC tissue detection.")
    p.add_argument("--slide_path", required=True)
    p.add_argument("--model_path", required=True,
                   help="tissue UNet++ weights (.npz)")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--min_area", type=float, default=0.0,
                   help="min region area in µm²")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default), 'cuda:N', 'gpu' or 'cpu'.")
    return main(p.parse_args(argv))


if __name__ == "__main__":
    main_with_args()
