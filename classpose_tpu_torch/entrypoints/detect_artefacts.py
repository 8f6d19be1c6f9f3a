"""``classpose-detect-artefacts-torch``: GrandQC artefact detection
(counterpart of the JAX package's ``classpose-detect-artefacts``, which
the QuPath artefact action drives).

    python -m classpose_tpu_torch.entrypoints.detect_artefacts \\
        --slide_path slide.svs --model_path artefact.npz \\
        --tissue_model_path tissue.npz --output_folder out

Writes ``{base}_artefact_contours.geojson`` and the tissue contours it
used (``{base}_tissue_contours.geojson``) into the output folder. The
nets run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from classpose_tpu_torch.grandqc import detect_artefacts_wsi
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.utils import get_device, get_geojson_output_filename

logger = get_logger(__name__)


def main(args):
    res = detect_artefacts_wsi(
        args.slide_path, model_path=args.model_path,
        tissue_model_path=args.tissue_model_path,
        device=get_device(getattr(args, "device", None)))
    out = Path(args.output_folder)
    out.mkdir(parents=True, exist_ok=True)
    base = Path(args.slide_path).name.rsplit(".", 1)[0]
    path = out / get_geojson_output_filename("artefact_contours", base)
    path.write_text(json.dumps(res["geojson"]))
    tpath = out / get_geojson_output_filename("tissue_contours", base)
    tpath.write_text(json.dumps(res["tissue"]["geojson"]))
    logger.info("wrote %s (%d regions) and %s", path,
                len(res["polygons_level0"]), tpath)
    return res


def main_with_args(argv=None):
    p = argparse.ArgumentParser(description="GrandQC artefact detection.")
    p.add_argument("--slide_path", required=True)
    p.add_argument("--model_path", required=True,
                   help="artefact UNet++ weights (.npz)")
    p.add_argument("--tissue_model_path", default=None,
                   help="tissue UNet++ weights (.npz); required unless the "
                   "artefact model path is reused")
    p.add_argument("--output_folder", required=True)
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default), 'cuda:N', 'gpu' or 'cpu'.")
    return main(p.parse_args(argv))


if __name__ == "__main__":
    main_with_args()
