"""GrandQC tissue and artefact quality control (counterpart of
``classpose_tpu/grandqc``): UNet++ nets on a TF-padded EfficientNet-B0
encoder, run batched on the card (or the CPU), and the tissue and
artefact WSI pipelines around them (thumbnail at a fixed MPP, JPEG
compression simulated, 512² patch grids, connected components filtered by
area in µm², region borders with holes, GeoJSON)."""

from classpose_tpu_torch.grandqc.artefact import detect_artefacts_wsi
from classpose_tpu_torch.grandqc.nets import (
    EfficientNetB0Encoder,
    UnetPlusPlus,
)
from classpose_tpu_torch.grandqc.tissue import detect_tissue_wsi

__all__ = [
    "UnetPlusPlus",
    "EfficientNetB0Encoder",
    "detect_tissue_wsi",
    "detect_artefacts_wsi",
]
