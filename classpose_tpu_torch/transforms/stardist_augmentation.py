"""StarDist-style augmentation pipeline (counterpart of
``classpose_tpu/transforms/stardist_augmentation.py``): a colour
transform chosen by coin flip between the HED perturbation and the NMF
H&E staining transform, then the image-quality chain. The sub-generators
are seeded from ``seed`` in the JAX package's order: HED, H&E, quality.
"""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.transforms.augmentation_configs import get_config
from classpose_tpu_torch.transforms.he_staining import HEStainingTransform
from classpose_tpu_torch.transforms.hed import HEDTransform
from classpose_tpu_torch.transforms.image_quality import (
    ImageQualityAugmentation,
)


class StarDistAugmentation:
    def __init__(self, config: dict | str = "enhanced", seed=None):
        if isinstance(config, str):
            config = get_config(config)
        self.config = config
        self.rng = np.random.default_rng(seed)
        color = config.get("color", {})
        quality = config.get("quality", {})
        self.hed_p = float(color.get("hed_p", 0.5))
        self.he_p = float(color.get("he_p", 0.5))
        self.hed = HEDTransform(
            magnitude=float(color.get("magnitude", 0.25)),
            seed=self.rng.integers(2**31),
        )
        self.he = HEStainingTransform(seed=self.rng.integers(2**31))
        self.quality = ImageQualityAugmentation(
            blur_p=float(quality.get("blur_p", 0.1)),
            noise_p=float(quality.get("noise_p", 0.8)),
            hbs_p=float(quality.get("hbs_p", 0.9)),
            seed=self.rng.integers(2**31),
        )

    def transform(self, img: np.ndarray) -> np.ndarray:
        total = self.hed_p + self.he_p
        if total > 0:
            r = self.rng.random() * total
            if r < self.hed_p:
                img = self.hed.transform(img)
            else:
                img = self.he.transform(img)
        return self.quality.transform(img)

    __call__ = transform


def create_stardist_augmentation(
    config: dict | str = "enhanced", seed=None
) -> StarDistAugmentation:
    return StarDistAugmentation(config, seed=seed)
