"""GrandQC tissue detection over a whole slide (counterpart of
``classpose_tpu/grandqc/tissue.py``): thumbnail at MPP 10, JPEG
compression simulated, 512² patches through the 2-class UNet++ (class 1
is tissue), connected components filtered by area in µm², region borders
with holes, and level-0 GeoJSON. Weights are the native ``.npz``
(``classpose-convert-weights-torch --kind grandqc``); tests replace
:func:`make_unetpp_predict_fn` with oracles.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from classpose_tpu_torch.geometry import Polygon
from classpose_tpu_torch.grandqc.helpers import (
    contours_to_geojson_features,
    contours_with_holes,
    extract_slide_thumbnail,
    filter_components_by_area,
    predict_mask,
    simulate_jpeg_compression,
)
from classpose_tpu_torch.io import get_wsi_reader
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.utils import get_device

logger = get_logger(__name__)

MPP_TISSUE_MODEL = 10.0
# ImageNet normalisation (smp's preprocessing for timm-efficientnet)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def no_tf32():
    """True fp32 products for the duration (the nets' fp32 contract); the
    TF32 switches are restored afterwards, so the ViT's own setting holds
    outside."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def load_unetpp(model_path: str, classes: int, device=None):
    """The UNet++ of a native GrandQC ``.npz``, in eval mode on
    ``device`` (default: the card)."""
    from classpose_tpu_torch.grandqc.convert import load_grandqc_npz
    from classpose_tpu_torch.grandqc.nets import UnetPlusPlus

    dev = get_device(None) if device is None else torch.device(device)
    sd, cfg = load_grandqc_npz(model_path, classes)
    net = UnetPlusPlus(cfg)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(dev, getattr(torch, cfg.dtype))


def unetpp_logits(net, batch) -> torch.Tensor:
    """(B, C, H, W) fp32 logits of uint8 (B, H, W, 3) patches on the
    net's device: ImageNet-normalised in fp32, with TF32 off."""
    dev = next(net.parameters()).device
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(_STD, dtype=torch.float32, device=dev)
    x = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
    with torch.no_grad(), no_tf32():
        x = (x.to(torch.float32) / 255.0 - mean) / std
        return net(x.permute(0, 3, 1, 2))


def make_unetpp_predict_fn(model_path: str, classes: int, device=None):
    """Load a UNet++ ``.npz`` and return a batched argmax predict_fn
    (patches (B, 512, 512, 3) uint8 → (B, 512, 512) int32) that runs on
    ``device`` (default: the card)."""
    net = load_unetpp(model_path, classes, device)
    return lambda batch: unetpp_logits(net, batch).argmax(1).to(
        torch.int32).cpu().numpy()


def detect_tissue_wsi(
    slide_or_path,
    model_path: str | None = None,
    predict_fn=None,
    min_area: float = 0.0,
    mpp_model: float = MPP_TISSUE_MODEL,
    jpeg_quality: int = 80,
    device=None,
) -> dict:
    """Run tissue detection. Returns a dict with keys: thumb, mask,
    mask_unfiltered (before the area filter), contours, polygons (level
    0), polygons_thumb, geojson, mpp, scale_to_level0."""
    slide = (get_wsi_reader()(slide_or_path)
             if isinstance(slide_or_path, str) else slide_or_path)
    thumb, scale, mpp = extract_slide_thumbnail(slide, mpp_model)
    thumb_sim = simulate_jpeg_compression(thumb, quality=jpeg_quality)

    if predict_fn is None:
        if model_path is None:
            raise ValueError(
                "either model_path or predict_fn must be provided")
        predict_fn = make_unetpp_predict_fn(model_path, classes=2,
                                            device=device)

    raw = predict_mask(thumb_sim, predict_fn) == 1
    mask = filter_components_by_area(raw, min_area, mpp_model)

    contour_list = contours_with_holes(mask)
    polygons = [Polygon(ext, holes=holes) for ext, holes in contour_list]
    polygons_level0 = [
        Polygon(ext * scale, holes=[h * scale for h in holes])
        for ext, holes in contour_list
    ]
    features = contours_to_geojson_features(
        contour_list, scale, "Tissue", color=[0, 160, 0])
    logger.info("Tissue detection: %d regions, %.1f%% of thumbnail",
                len(polygons), 100.0 * mask.mean())
    return {
        "thumb": thumb,
        "mask": mask,
        "mask_unfiltered": raw.astype(np.uint8),
        "contours": contour_list,
        "polygons": polygons_level0,
        "polygons_thumb": polygons,
        "geojson": {"type": "FeatureCollection", "features": features},
        "mpp": mpp,
        "scale_to_level0": scale,
    }
