"""Histology augmentations on the host, in numpy (counterpart of
``classpose_tpu/transforms/``): HED stain perturbation, the NMF H&E
staining transform, image-quality augmentations and the StarDist pipeline
that chains them. No OpenCV and no scikit-learn: ``cvlite.py`` and
``nmf.py`` hold the numpy copies of the calls the JAX package makes."""

from classpose_tpu_torch.transforms.augmentation_configs import (
    AUGMENTATION_CONFIGS,
    create_custom_config,
    get_config,
)
from classpose_tpu_torch.transforms.he_staining import HEStainingTransform
from classpose_tpu_torch.transforms.hed import HEDTransform
from classpose_tpu_torch.transforms.image_quality import (
    AdditiveNoiseTransform,
    GaussianBlurTransform,
    HueBrightnessSaturationTransform,
    ImageQualityAugmentation,
)
from classpose_tpu_torch.transforms.stardist_augmentation import (
    StarDistAugmentation,
    create_stardist_augmentation,
)

__all__ = [
    "HEDTransform",
    "HEStainingTransform",
    "AdditiveNoiseTransform",
    "GaussianBlurTransform",
    "HueBrightnessSaturationTransform",
    "ImageQualityAugmentation",
    "StarDistAugmentation",
    "create_stardist_augmentation",
    "AUGMENTATION_CONFIGS",
    "create_custom_config",
    "get_config",
]
