"""HED stain-space colour augmentation (counterpart of
``classpose_tpu/transforms/hed.py``, the same numpy operations, so equal
bit for bit).

RGB is deconvolved into the Ruifrok H/E/DAB optical-density space with an
explicit shift (``-log(rgb + shift)``, shift = |min| + 1 for inputs with
negatives, such as cellpose-normalised images, else 1); each stain gets a
multiplicative (sigma) and an additive (bias) perturbation; the result is
reconvolved (``exp(-hed · M) - shift``) and clipped to [-1, 1], then to
[0, 1]. ``simple_mode`` assumes [0, 1] inputs and uses the plain ``-log``
round trip with no shift.

uint8 patches are divided by 255 and restored; float patches are used
as they are, with the cutoff applied to the raw mean (so the transform
fires only on ~[0, 1]-scaled or normalised float data).
"""

from __future__ import annotations

import numpy as np

# Ruifrok & Johnston H/E/DAB stain matrix and its float32 inverse
RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ],
    np.float32,
)
HED_FROM_RGB = np.linalg.inv(RGB_FROM_HED).astype(np.float32)


def rgb2hed(
    rgb: np.ndarray, simple_mode: bool = False
) -> tuple[np.ndarray, float]:
    """RGB → HED stains; returns (stains, shift) where ``shift`` is the
    offset added before the log."""
    rgb = np.asarray(rgb, np.float32)
    if simple_mode:
        rgb = np.clip(rgb, 1e-6, 1.0)
        stains = np.reshape(-np.log(rgb), (-1, 3)) @ HED_FROM_RGB
        return np.reshape(stains, rgb.shape), 0.0
    shift = float(rgb.min())
    shift = abs(shift) + 1.0 if shift < 0 else 1.0
    rgb = rgb + np.float32(shift)
    stains = np.reshape(-np.log(rgb), (-1, 3)) @ HED_FROM_RGB
    return np.reshape(stains, rgb.shape), shift


def hed2rgb(hed: np.ndarray, shift: float) -> np.ndarray:
    """HED stains → RGB, undoing the shift."""
    hed = np.asarray(hed, np.float32)
    logrgb2 = -np.reshape(hed, (-1, 3)) @ RGB_FROM_HED
    rgb2 = np.reshape(np.exp(logrgb2), hed.shape)
    if shift == 0.0:
        return np.clip(rgb2, 0.0, 1.0)
    # rescale_intensity(x, in_range=(-1,1)) on float == clip to [-1, 1]
    return np.clip(rgb2 - np.float32(shift), -1.0, 1.0)


class HEDTransform:
    """Per-stain sigma/bias perturbation.

    ``sigma_ranges``/``bias_ranges`` are three (low, high) tuples sampled
    uniformly per channel; the convenience ``magnitude`` fills all six
    ranges with ±magnitude. ``p`` (used by the StarDist pipeline) skips
    the transform stochastically; at the default p=1.0 no random draw is
    consumed."""

    def __init__(
        self,
        sigma_ranges: list[tuple[float, float]] | None = None,
        bias_ranges: list[tuple[float, float]] | None = None,
        cutoff_range: tuple[float, float] = (0.15, 0.85),
        seed=None,
        channel_dimension: int | None = None,
        simple_mode: bool = False,
        magnitude: float = 0.25,
        p: float = 1.0,
    ):
        r = (-float(magnitude), float(magnitude))
        self.sigma_ranges = (
            [tuple(t) for t in sigma_ranges] if sigma_ranges else [r] * 3
        )
        self.bias_ranges = (
            [tuple(t) for t in bias_ranges] if bias_ranges else [r] * 3
        )
        self.cutoff_range = tuple(cutoff_range)
        self.channel_dimension = channel_dimension  # None = auto-detect
        self.simple_mode = simple_mode
        self.p = float(p)
        self.rng = (
            seed if isinstance(seed, np.random.Generator)
            else np.random.default_rng(seed)
        )

    def sample_sigma(self) -> list[float]:
        return [
            float(self.rng.uniform(lo, hi)) for lo, hi in self.sigma_ranges
        ]

    def sample_bias(self) -> list[float]:
        return [
            float(self.rng.uniform(lo, hi)) for lo, hi in self.bias_ranges
        ]

    def _channels_last(self, patch: np.ndarray) -> bool:
        if self.channel_dimension is not None:
            return self.channel_dimension == 2
        return not (patch.ndim == 3 and patch.shape[0] in (1, 3))

    def transform(self, patch: np.ndarray) -> np.ndarray:
        if self.p < 1.0 and self.rng.random() > self.p:
            return patch
        patch = np.asarray(patch)
        original_dtype = patch.dtype
        patch_mean = float(np.mean(patch))
        if original_dtype == np.uint8:
            patch = patch / 255.0
            patch_mean = patch_mean / 255.0
        elif original_dtype not in (np.float16, np.float32, np.float64):
            raise ValueError(f"Unsupported patch dtype: {original_dtype}")
        lo, hi = self.cutoff_range
        if not (lo <= patch_mean <= hi):
            return (
                patch.astype(original_dtype)
                if original_dtype != np.uint8
                else (patch * 255).astype(np.uint8)
            )

        channels_last = self._channels_last(patch)
        img = patch if channels_last else np.transpose(patch, (1, 2, 0))
        hed, shift = rgb2hed(img, simple_mode=self.simple_mode)

        sigmas = self.sample_sigma()
        biases = self.sample_bias()
        for i in range(3):
            hed[:, :, i] = hed[:, :, i] * (1.0 + sigmas[i]) + biases[i]

        rgb = np.clip(hed2rgb(hed, shift), 0.0, 1.0)
        out = rgb if channels_last else np.transpose(rgb, (2, 0, 1))
        if original_dtype == np.uint8:
            return (out * 255).astype(np.uint8)
        return out.astype(original_dtype)

    def transform_batch(self, patches: np.ndarray) -> np.ndarray:
        return np.array([self.transform(p) for p in patches])

    __call__ = transform
