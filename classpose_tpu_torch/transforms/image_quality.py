"""Image-quality augmentations (counterpart of
``classpose_tpu/transforms/image_quality.py``): Gaussian blur (p=0.1,
σ ∈ [0, 2]), additive Gaussian noise (p=0.8, σ = 0.01 of the value range)
and hue/brightness/saturation jitter (p=0.9), with the JAX package's
random draws in its order. Where the JAX package calls OpenCV, the port
calls its numpy copies in ``cvlite.py``, which give the same floats.
"""

from __future__ import annotations

import numpy as np

from classpose_tpu_torch.transforms.cvlite import (
    gaussian_blur,
    hsv2rgb,
    rgb2hsv,
)


class _Base:
    def __init__(self, p: float, seed=None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def _roll(self) -> bool:
        return self.rng.random() < self.p

    def __call__(self, img):
        return self.transform(img)


def _to_hwc(img):
    img = np.asarray(img, np.float32)
    chw = img.ndim == 3 and img.shape[0] in (1, 3)
    return (np.moveaxis(img, 0, -1) if chw else img), chw


def _from_hwc(img, chw):
    return np.moveaxis(img, -1, 0).astype(np.float32) if chw else \
        img.astype(np.float32)


class GaussianBlurTransform(_Base):
    def __init__(self, p: float = 0.1, sigma_range=(0.0, 2.0), seed=None):
        super().__init__(p, seed)
        self.sigma_range = sigma_range

    def transform(self, img):
        if not self._roll():
            return img
        sigma = float(self.rng.uniform(*self.sigma_range))
        if sigma <= 0:
            return img
        hwc, chw = _to_hwc(img)
        return _from_hwc(gaussian_blur(hwc, sigma), chw)


class AdditiveNoiseTransform(_Base):
    def __init__(self, p: float = 0.8, sigma: float = 0.01, seed=None):
        super().__init__(p, seed)
        self.sigma = sigma

    def transform(self, img):
        if not self._roll():
            return img
        img = np.asarray(img, np.float32)
        span = max(float(img.max() - img.min()), 1e-6)
        return img + self.rng.normal(
            0, self.sigma * span, img.shape
        ).astype(np.float32)


class HueBrightnessSaturationTransform(_Base):
    def __init__(
        self,
        p: float = 0.9,
        hue: float = 0.1,
        brightness: float = 0.1,
        saturation: float = 0.1,
        seed=None,
    ):
        super().__init__(p, seed)
        self.hue = hue
        self.brightness = brightness
        self.saturation = saturation

    def transform(self, img):
        if not self._roll():
            return img
        hwc, chw = _to_hwc(img)
        if hwc.shape[-1] != 3:
            return img
        shift = min(0.0, float(hwc.min()))
        span = max(float(hwc.max() - shift), 1e-6)
        unit = np.clip((hwc - shift) / span, 0, 1)
        hsv = rgb2hsv(unit)
        dh = self.rng.uniform(-self.hue, self.hue) * 360.0
        db = 1 + self.rng.uniform(-self.brightness, self.brightness)
        dsat = 1 + self.rng.uniform(-self.saturation, self.saturation)
        hsv[..., 0] = (hsv[..., 0] + dh) % 360.0
        hsv[..., 1] = np.clip(hsv[..., 1] * dsat, 0, 1)
        hsv[..., 2] = np.clip(hsv[..., 2] * db, 0, 1)
        out = hsv2rgb(hsv) * span + shift
        return _from_hwc(out, chw)


class ImageQualityAugmentation:
    """Blur, then noise, then hue/brightness/saturation, each with its
    own generator seeded from ``seed`` in that order."""

    def __init__(self, blur_p=0.1, noise_p=0.8, hbs_p=0.9, seed=None):
        rng = np.random.default_rng(seed)
        self.transforms = [
            GaussianBlurTransform(blur_p, seed=rng.integers(2**31)),
            AdditiveNoiseTransform(noise_p, seed=rng.integers(2**31)),
            HueBrightnessSaturationTransform(hbs_p,
                                             seed=rng.integers(2**31)),
        ]

    def transform(self, img):
        for t in self.transforms:
            img = t.transform(img)
        return img

    __call__ = transform
