"""GrandQC artefact detection over a whole slide (counterpart of
``classpose_tpu/grandqc/artefact.py``): tissue detection first (without
an area filter), thumbnail at MPP 1, 512² patches through the 8-class
UNet++ only where a patch holds ≥ 50 tissue pixels, classes 2–6 (fold,
darkspot, pen, edge, out of focus) with non-tissue forced to 7, per-class
region borders with holes above 10 px, a coloured class map, and level-0
GeoJSON.
"""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.geometry import Polygon
from classpose_tpu_torch.grandqc import tissue as tissue_mod
from classpose_tpu_torch.grandqc.helpers import (
    ARTEFACT_CLASS_COLORS,
    ARTEFACT_CLASS_NAMES,
    contours_to_geojson_features,
    contours_with_holes,
    extract_slide_thumbnail,
    predict_mask,
    simulate_jpeg_compression,
)
from classpose_tpu_torch.io import get_wsi_reader
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.transforms.cvlite import resize_nearest

logger = get_logger(__name__)

MPP_ARTEFACT_MODEL = 1.0
MIN_TISSUE_PIXELS = 50
NON_TISSUE_CLASS = 7
MIN_CONTOUR_AREA_PX = 10


def detect_artefacts_wsi(
    slide_or_path,
    model_path: str | None = None,
    predict_fn=None,
    tissue_model_path: str | None = None,
    tissue_predict_fn=None,
    tissue_result: dict | None = None,
    mpp_model: float = MPP_ARTEFACT_MODEL,
    jpeg_quality: int = 80,
    n_classes: int = 8,
    device=None,
) -> dict:
    """Run artefact detection. Returns a dict with keys: mask, colormap,
    contours (per class), polygons and polygons_level0 (level 0),
    geojson, scale_to_level0, tissue (the tissue result used), mpp.

    ``tissue_result`` must come from :func:`detect_tissue_wsi` with no
    area filter (its ``mask``), as the stage runs it itself otherwise."""
    slide = (get_wsi_reader()(slide_or_path)
             if isinstance(slide_or_path, str) else slide_or_path)
    if tissue_result is None:
        tissue_result = tissue_mod.detect_tissue_wsi(
            slide, model_path=tissue_model_path,
            predict_fn=tissue_predict_fn, device=device)

    thumb, scale, mpp = extract_slide_thumbnail(slide, mpp_model)
    thumb_sim = simulate_jpeg_compression(thumb, quality=jpeg_quality)

    # the tissue mask from the MPP-10 grid onto the MPP-1 grid
    tmask = resize_nearest(tissue_result["mask"].astype(np.uint8),
                           thumb.shape[1], thumb.shape[0]).astype(bool)

    if predict_fn is None:
        if model_path is None:
            raise ValueError(
                "either model_path or predict_fn must be provided")
        predict_fn = tissue_mod.make_unetpp_predict_fn(
            model_path, classes=n_classes, device=device)

    def patch_filter(y, x, p):
        return tmask[y : y + p.shape[0], x : x + p.shape[1]].sum() >= \
            MIN_TISSUE_PIXELS

    mask = predict_mask(thumb_sim, predict_fn, patch_filter=patch_filter,
                        fill_value=NON_TISSUE_CLASS)
    mask[~tmask] = NON_TISSUE_CLASS

    colormap = np.zeros((*mask.shape, 3), np.uint8)
    contours: dict[int, list] = {}
    polygons_level0 = []
    features = []
    for cls, name in ARTEFACT_CLASS_NAMES.items():
        cls_mask = (mask == cls).astype(np.uint8)
        if cls_mask.sum() == 0:
            contours[cls] = []
            continue
        clist = contours_with_holes(cls_mask, min_area_px=MIN_CONTOUR_AREA_PX)
        contours[cls] = clist
        color = ARTEFACT_CLASS_COLORS[cls]
        colormap[mask == cls] = color
        polygons_level0.extend(
            Polygon(ext * scale, holes=[h * scale for h in holes])
            for ext, holes in clist)
        features.extend(
            contours_to_geojson_features(clist, scale, name, color=color))

    logger.info("Artefact detection: %d artefact regions across %d classes",
                len(polygons_level0),
                sum(1 for v in contours.values() if v))
    return {
        "mask": mask,
        "colormap": colormap,
        "contours": contours,
        "polygons": polygons_level0,
        "polygons_level0": polygons_level0,
        "geojson": {"type": "FeatureCollection", "features": features},
        "scale_to_level0": scale,
        "tissue": tissue_result,
        "mpp": mpp,
    }
