"""The port's augmentations (``classpose_tpu_torch/transforms``) against
the JAX package's on the CPU, and its numpy copies of the library calls
those make against the libraries themselves: ``nmf_random_cd`` against
scikit-learn's ``NMF``, ``gaussian_blur`` / ``rgb2hsv`` / ``hsv2rgb``
against OpenCV. Every comparison is bitwise (``tobytes``); the copies
reproduce OpenCV's order of operations and fused multiply-adds, and
scikit-learn's coordinate-descent loop and stopping test."""

import warnings

import cv2
import numpy as np
import pytest
from sklearn.decomposition import NMF

import classpose_tpu.transforms as jt
import classpose_tpu.transforms.he_staining as jax_he
import classpose_tpu_torch.transforms as pt
import classpose_tpu_torch.transforms.he_staining as port_he
from classpose_tpu_torch.transforms import cvlite
from classpose_tpu_torch.transforms.nmf import nmf_random_cd


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def he_like(seed: int, size: int = 96, chw: bool = True) -> np.ndarray:
    """An H&E-like float image in [0, 255]: a pink background, purple
    nuclei, noise."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), [225, 195, 215], np.float32)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(size // 8):
        cy, cx = rng.integers(6, size - 6, 2)
        r = rng.integers(4, 9)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = \
            [100, 60, 140] + rng.normal(0, 10, 3)
    img += rng.normal(0, 3, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255).astype(np.float32)
    return img.transpose(2, 0, 1) if chw else img


# -------------------------------------------------------------------- HED

@pytest.mark.parametrize("case", ["chw_float", "hwc_float", "chw_uint8",
                                  "hwc_uint8", "simple", "normalized",
                                  "outside_cutoff"])
def test_hed_bitwise(case):
    img = he_like(1, chw=case.startswith("chw")) / np.float32(255)
    kw = {}
    if case.endswith("uint8"):
        img = (img * 255).astype(np.uint8)
    elif case == "simple":
        kw = dict(simple_mode=True)
    elif case == "normalized":
        img = (img - img.mean()) / img.std() * np.float32(0.2) + \
            np.float32(0.5)
    elif case == "outside_cutoff":
        img = img * np.float32(0.1)
    a = jt.HEDTransform(seed=3, **kw)
    b = pt.HEDTransform(seed=3, **kw)
    for _ in range(3):
        ra, rb = a(img), b(img)
        assert bits_equal(ra, rb)
    if case == "outside_cutoff":
        assert bits_equal(rb, img)
    else:
        assert not np.array_equal(rb, img)


def test_hed_matrices_and_roundtrip_bitwise():
    from classpose_tpu.transforms import hed as jh
    from classpose_tpu_torch.transforms import hed as ph

    assert bits_equal(jh.HED_FROM_RGB, ph.HED_FROM_RGB)
    assert bits_equal(jh.RGB_FROM_HED, ph.RGB_FROM_HED)
    rgb = he_like(2, chw=False) / np.float32(255)
    for simple in (False, True):
        (sa, sha), (sb, shb) = jh.rgb2hed(rgb, simple), ph.rgb2hed(rgb,
                                                                   simple)
        assert bits_equal(sa, sb) and sha == shb
        assert bits_equal(jh.hed2rgb(sa, sha), ph.hed2rgb(sb, shb))


# -------------------------------------------------------------------- NMF

def _sklearn_nmf(X, seed):
    m = NMF(n_components=2, init="random", random_state=seed, max_iter=200)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.fit(X)
    return m.components_, m.n_iter_


@pytest.mark.parametrize("kind,seed", [("he", 0), ("he", 5), ("random", 1),
                                       ("random", 7), ("he64", 3)])
def test_nmf_bitwise_against_sklearn(kind, seed):
    """Components and iteration count, float32 (the stain path's dtype) and
    float64, on optical densities of an H&E-like image and on uniform
    data (which converges early)."""
    rng = np.random.default_rng(seed)
    if kind.startswith("he"):
        rgb = he_like(seed, chw=False) / np.float32(255)
        X = -np.log(np.clip(rgb.reshape(-1, 3), 1e-6, 1.0))
        X = X[(X > 0.15).any(axis=1)]
    else:
        X = rng.random((2500, 3)).astype(np.float32)
    if kind == "he64":
        X = X.astype(np.float64)
    H, n_iter = nmf_random_cd(X, 2, seed)
    H_ref, n_ref = _sklearn_nmf(X, seed)
    assert n_iter == n_ref
    assert bits_equal(H, H_ref)


def test_extract_stain_matrix_none_under_100_pixels():
    rgb = np.ones((20, 20, 3), np.float32)
    rgb[:9, :11] = [0.3, 0.2, 0.5]          # 99 foreground pixels
    assert jax_he.extract_stain_matrix(rgb) is None
    assert port_he.extract_stain_matrix(rgb) is None
    rgb[9, 0] = [0.3, 0.2, 0.5]             # 100
    a, b = jax_he.extract_stain_matrix(rgb), port_he.extract_stain_matrix(rgb)
    assert bits_equal(a[0], b[0])


def test_extract_stain_matrix_subsamples_above_50000():
    """A 232² image has 53 824 foreground pixels: both draw the same
    50 000 with ``default_rng(seed).choice`` and fit the same basis."""
    rgb = he_like(4, size=232, chw=False) / np.float32(255)
    rgb = rgb * np.float32(0.8)             # every pixel foreground
    od = -np.log(np.clip(rgb.reshape(-1, 3), 1e-6, 1.0))
    assert (od > 0.15).any(axis=1).sum() > 50_000
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = jax_he.extract_stain_matrix(rgb, seed=11)
    b = port_he.extract_stain_matrix(rgb, seed=11)
    assert bits_equal(a[0], b[0]) and a[1] is None and b[1] is None
    assert b[0].shape == (2, 3) and b[0][0, 2] >= b[0][1, 2]


@pytest.mark.parametrize("chw", [True, False])
def test_he_staining_transform_bitwise(chw):
    a, b = jt.HEStainingTransform(seed=9), pt.HEStainingTransform(seed=9)
    for i in range(3):
        img = he_like(10 + i, chw=chw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ra = a(img)
        rb = b(img)
        assert bits_equal(ra, rb)
        assert not np.array_equal(rb, img)


# ------------------------------------------------------------- OpenCV copies

# ksize = round(8σ + 1) | 1 grows by 2 at σ = (2m + 0.5) / 8: each step,
# just below, on it (cvRound's half-to-even) and just above, up to σ = 2
KSIZE_STEPS = [(2 * m + 0.5) / 8 for m in range(8)]
SIGMAS = sorted({round(s + d, 4) for s in KSIZE_STEPS
                 for d in (-0.01, 0.0, 0.01) if s + d > 0} | {2.0})


@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur_bitwise(channels):
    """Every σ of ``SIGMAS`` on images whose rows are and are not a
    multiple of OpenCV's vector widths, 2-D and (H, W, C)."""
    rng = np.random.default_rng(channels)
    for shape in ((37, 45), (64, 64), (19, 33), (5, 131)):
        img = rng.random(shape + ((channels,) if channels == 3 else ())
                         ).astype(np.float32)
        for sigma in SIGMAS:
            ref = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
            assert bits_equal(cvlite.gaussian_blur(img, sigma), ref), \
                (shape, sigma)


def test_gaussian_blur_narrow_images():
    """Images narrower or shorter than the kernel's radius, where the
    border reflects more than once, and single rows and columns."""
    rng = np.random.default_rng(0)
    img = rng.random((8, 8, 3)).astype(np.float32)
    ref = cv2.GaussianBlur(img, (0, 0), sigmaX=2.0, sigmaY=2.0)
    assert bits_equal(cvlite.gaussian_blur(img, 2.0), ref)
    for shape in ((1, 9, 3), (9, 1, 3), (2, 3), (3, 2, 3), (1, 1, 3)):
        img = rng.random(shape).astype(np.float32)
        for sigma in (0.4, 1.0, 2.0):
            ref = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
            assert bits_equal(cvlite.gaussian_blur(img, sigma),
                              ref.reshape(img.shape)), (shape, sigma)


def _hsv_probe(seed: int, shape=(48, 61)) -> np.ndarray:
    """RGB in [0, 1] with greys, pure primaries and secondaries, ties
    between channels, quantized levels and red-max pixels with g < b
    (the hue wrap)."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape + (3,)).astype(np.float32)
    k = shape[0] // 6
    x[:k] = x[:k, :, :1]
    x[k:2 * k] = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                           [0, 1, 1], [1, 0, 1]], np.float32)[
        rng.integers(0, 6, (k, shape[1]))]
    x[2 * k:3 * k, :, 1] = x[2 * k:3 * k, :, 0]
    x[3 * k:4 * k] = np.round(x[3 * k:4 * k] * 4) / 4
    x[4 * k:5 * k, :, 0] = 1.0
    x[4 * k:5 * k, :, 1] = x[4 * k:5 * k, :, 2] * np.float32(0.5)
    return x


@pytest.mark.parametrize("seed,shape", [(0, (48, 61)), (1, (40, 64)),
                                        (2, (7, 5))])
def test_hsv_bitwise(seed, shape):
    x = _hsv_probe(seed, shape)
    hsv = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    assert bits_equal(cvlite.rgb2hsv(x), hsv)
    # the transform's hue shift and wrap, saturation scale, and hues on
    # the circle's ends
    hsv[..., 0] = (hsv[..., 0] + np.float32(-23.5)) % 360.0
    hsv[..., 1] = np.clip(hsv[..., 1] * np.float32(1.07), 0, 1)
    hsv[0, :, 0] = 360.0
    hsv[1, :, 0] = np.float32(359.99997)
    hsv[2, :, 0] = 0.0
    hsv[3, :, 1] = 0.0
    assert bits_equal(cvlite.hsv2rgb(hsv),
                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_fma32_rounds_once():
    """``fma32`` against the exact value rounded once: products of
    float32 pairs are exact in float64, and with c = -p rounded the sum
    is the product's rounding error, which a separate rounding loses."""
    rng = np.random.default_rng(0)
    a = rng.random(10_000).astype(np.float32)
    b = rng.random(10_000).astype(np.float32)
    p = a.astype(np.float64) * b
    c = -(p.astype(np.float32))
    got = cvlite.fma32(a, b, c)
    assert bits_equal(got, (p + c).astype(np.float32))
    assert (got != 0).mean() > 0.5 and ((a * b + c) == 0).all()


# ------------------------------------------------------------- the pipeline

def _draws(a, b, n: int = 20):
    for i in range(n):
        img = he_like(100 + i)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ra = a(img.copy())
        rb = b(img.copy())
        assert bits_equal(ra, rb), i


@pytest.mark.parametrize("cls,kw", [
    ("GaussianBlurTransform", dict(p=1.0)),
    ("AdditiveNoiseTransform", dict(p=0.8)),
    ("HueBrightnessSaturationTransform", dict(p=0.9)),
])
def test_quality_transform_bitwise(cls, kw):
    _draws(getattr(jt, cls)(seed=2, **kw), getattr(pt, cls)(seed=2, **kw),
           n=6)


def test_image_quality_augmentation_bitwise():
    _draws(jt.ImageQualityAugmentation(0.5, 0.8, 0.9, seed=4),
           pt.ImageQualityAugmentation(0.5, 0.8, 0.9, seed=4))


@pytest.mark.parametrize("config", [
    "enhanced", "hed_only",
    pt.create_custom_config(hed_p=0.3, he_p=0.7, magnitude=0.1, blur_p=0.5,
                            noise_p=0.5, hbs_p=0.5)],
    ids=["enhanced", "hed_only", "custom"])
def test_stardist_augmentation_bitwise(config):
    """20 seeded draws: the coin flip between HED and H&E staining, then
    blur, noise, hue/brightness/saturation, as the JAX pipeline draws them
    (HED fires on [0, 1] data, so the images are scaled)."""
    a = jt.StarDistAugmentation(config, seed=7)
    b = pt.StarDistAugmentation(config, seed=7)

    def scaled(t):
        return lambda img: t(img / np.float32(255))

    _draws(scaled(a), scaled(b))


def test_configs_equal():
    assert pt.AUGMENTATION_CONFIGS == jt.AUGMENTATION_CONFIGS
    assert pt.get_config("enhanced") == jt.get_config("enhanced")
    assert pt.create_custom_config(0.1) == jt.create_custom_config(0.1)
    with pytest.raises(ValueError, match="Unknown augmentation"):
        pt.get_config("nope")
    assert isinstance(pt.create_stardist_augmentation("hed_only"),
                      pt.StarDistAugmentation)
