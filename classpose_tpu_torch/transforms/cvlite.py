"""numpy copies of the two OpenCV calls of the image-quality transforms:
``cv2.GaussianBlur(img, (0, 0), σ, σ)`` and ``cv2.cvtColor`` between RGB
and HSV, on float32 images, bit for bit as OpenCV 5's x86-64 build
computes them.

The blur is OpenCV's separable filter. Its kernel is
``getGaussianKernel(round(8σ + 1) | 1, σ)``: exp(-x²/2σ²) in float64,
scaled by the reciprocal of its sum, rounded to float32. The border is
``BORDER_REFLECT_101``, repeated where the image is narrower than the
kernel's radius. Each pass keeps OpenCV's order of operations, element
for element along a row of ``W × C`` floats:

- rows, kernel of 3 or 5 taps (``SymmRowSmallFilter``): the centre tap's
  product fused into ``(x₋₁ + x₁)·k₁``, then ``(x₋₂ + x₂)`` fused on top;
  the last element of an odd row runs the scalar loop (fused for 3 taps,
  unfused for 5);
- rows, 7 taps or more (``RowFilter``): taps summed in order with fused
  multiply-adds over the largest multiple of 4 elements; after that, the
  scalar loop adds the taps unfused in steps of 4 and fuses the last
  ``(taps - 1) % 4``;
- columns, 3 taps: centre product, then the mirrored pair fused on top;
- columns, 5 taps or more (``SymmColumnFilter``): the centre product,
  then the mirrored pairs ``x₋ⱼ + xⱼ`` in order, fused over the largest
  multiple of 8 elements, unfused after.

A fused multiply-add is one rounding of ``a·b + c`` (:func:`fma32`).
"""

from __future__ import annotations

import numpy as np

FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` with one rounding. The product is exact in
    float64; the float64 sum is rounded to odd (the TwoSum error decides
    the last bit), so the final rounding to float32 is the correct one."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.copysign(np.inf, err)), s)
    return s.astype(np.float32)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(round(8σ + 1) | 1, σ, CV_32F)``."""
    ksize = int(round(sigma * 8 + 1)) | 1
    x = np.arange(ksize) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def reflect101(n: int, r: int) -> np.ndarray:
    """Source index of each of ``n + 2r`` positions, ``r`` beyond each
    end, under ``BORDER_REFLECT_101`` (OpenCV's ``borderInterpolate``)."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _split(fused: np.ndarray, plain: np.ndarray, cut: int) -> np.ndarray:
    """``fused`` on the first ``cut`` elements of each row, ``plain``
    after."""
    return np.concatenate([fused[:, :cut], plain[:, cut:]], axis=1)


def _row_pass(p: np.ndarray, k: np.ndarray, n: int, cn: int) -> np.ndarray:
    """``p`` (rows, n + 2r·cn): the padded rows; returns (rows, n)."""
    ks = len(k)
    r = ks // 2

    def tap(j):
        return p[:, (r + j) * cn:(r + j) * cn + n]

    if ks in (3, 5):
        acc = fma32(tap(0), k[r], (tap(-1) + tap(1)) * k[r + 1])
        if ks == 5:
            acc = fma32(tap(2) + tap(-2), k[r + 2], acc)
        if n % 2:
            last = tap(0)[:, -1:] * k[r]
            for j in range(1, r + 1):
                pair = tap(j)[:, -1:] + tap(-j)[:, -1:]
                last = (fma32(pair, k[r + j], last) if ks == 3
                        else last + pair * k[r + j])
            acc = np.concatenate([acc[:, :-1], last], axis=1)
        return acc
    fused = plain = tap(-r) * k[0]
    unrolled = (ks - 1) // 4 * 4
    for j in range(1, ks):
        fused = fma32(tap(j - r), k[j], fused)
        plain = (plain + tap(j - r) * k[j] if j <= unrolled
                 else fma32(tap(j - r), k[j], plain))
    return _split(fused, plain, n // 4 * 4)


def _col_pass(p: np.ndarray, k: np.ndarray, rows: int) -> np.ndarray:
    """``p`` (rows + 2r, n): the padded columns; returns (rows, n)."""
    r = len(k) // 2

    def tap(j):
        return p[r + j:r + j + rows]

    fused = plain = tap(0) * k[r]
    for j in range(1, r + 1):
        pair = tap(j) + tap(-j)
        fused = fma32(pair, k[r + j], fused)
        plain = plain + pair * k[r + j]
    return fused if r == 1 else _split(fused, plain, p.shape[1] // 8 * 8)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigmaX=σ, sigmaY=σ)`` on a float32
    (H, W) or (H, W, C) image, σ > 0; returns the same shape."""
    img = np.asarray(img, np.float32)
    k = gaussian_kernel(float(sigma))
    if len(k) == 1:
        return img.copy()
    r = len(k) // 2
    h, w = img.shape[:2]
    cn = img.shape[2] if img.ndim == 3 else 1
    n = w * cn
    out = img.reshape(h, n)
    if w > 1:
        rows = img.reshape(h, w, cn)[:, reflect101(w, r)].reshape(h, -1)
        out = _row_pass(rows, k, n, cn)
    if h > 1:
        out = _col_pass(out[reflect101(h, r)], k, h)
    return out.reshape(img.shape)


def _row_tail(shape: tuple[int, ...]) -> np.ndarray:
    """(H, W) mask of the pixels past the largest multiple of 8 in each
    row: the ones ``cvtColor``'s scalar loop converts."""
    w = shape[1]
    return np.broadcast_to(np.arange(w) >= w // 8 * 8, shape[:2])


def rgb2hsv(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)`` on float32 (H, W, 3) RGB:
    H in degrees [0, 360), S and V as ``(max - min) / (|max| + ε)`` and
    ``max``. With d = 60 / (max - min + ε), the vector loop takes
    H = fma(g - b, d, g < b ? 360 : 0) where r is the maximum,
    fma(b - r, d, 120) where g is, fma(r - g, d, 240) else; the scalar
    loop rounds (g - b)·d first and adds 360 where it is negative."""
    rgb = np.asarray(rgb, np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + FLT_EPSILON)
    d = np.float32(60) / (diff + FLT_EPSILON)
    r_max, g_max = r == v, g == v
    h_vec = fma32(np.where(r_max, g - b, np.where(g_max, b - r, r - g)), d,
                  np.where(r_max, np.where(g < b, np.float32(360), 0),
                           np.where(g_max, np.float32(120), 240)
                           ).astype(np.float32))
    h_scalar = np.where(r_max, (g - b) * d,
                        np.where(g_max, fma32(b - r, d, np.float32(120)),
                                 fma32(r - g, d, np.float32(240))))
    h_scalar = np.where(h_scalar < 0, h_scalar + np.float32(360), h_scalar)
    h = np.where(_row_tail(rgb.shape), h_scalar, h_vec)
    return np.stack([h, s, v], axis=-1)


# (b, g, r) taken from (v, v(1 - s), v(1 - s·f), v(1 - s(1 - f))) in each
# sixth of the hue circle (OpenCV's ``sector_data``)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def _hsv_tabs(f, s, v):
    one = np.float32(1)
    return np.stack([v, v * (one - s), v * fma32(-s, f, one),
                     v * fma32(-s, one - f, one)])


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` on float32 (H, W, 3) HSV
    with H in degrees. The sector is ``trunc(H · 6/360)`` taken modulo 6
    (vector loop) or ``floor(fmod(H · 6/360, 6))`` (scalar loop, which
    also returns V where S is 0); both fuse ``1 - s·f``."""
    hsv = np.asarray(hsv, np.float32)
    h = hsv[..., 0] * (np.float32(6) / np.float32(360))
    s, v = hsv[..., 1], hsv[..., 2]

    pre = np.trunc(h)
    sec_vec = (pre - np.trunc(pre * np.float32(1 / 6)) * np.float32(6))
    tabs_vec = _hsv_tabs(h - pre, s, v)

    hs = np.fmod(h, np.float32(6))
    sec = np.floor(hs)
    frac = hs - sec
    bad = (sec < 0) | (sec >= 6)
    sec_sc = np.where(bad, 0, sec).astype(np.int64)
    tabs_sc = _hsv_tabs(np.where(bad, np.float32(0), frac), s, v)

    tail = _row_tail(hsv.shape)
    sec = np.where(tail, sec_sc, sec_vec.astype(np.int64))
    tabs = np.where(tail, tabs_sc, tabs_vec)
    bgr = [np.take_along_axis(tabs, _SECTORS[sec][..., c][None], 0)[0]
           for c in range(3)]
    out = np.stack(bgr[::-1], axis=-1)
    return np.where((tail & (s == 0))[..., None], v[..., None], out)
