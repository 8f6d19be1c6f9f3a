"""numpy copies of OpenCV calls, bit for bit as OpenCV 5's x86-64 build
(with its IPP HAL) computes them: the image-quality transforms'
``cv2.GaussianBlur(img, (0, 0), σ, σ)`` and ``cv2.cvtColor`` between RGB
and HSV on float32 images, and ``cv2.resize`` with ``INTER_LINEAR`` and
``INTER_NEAREST`` (the semantic baseline's rescale; see :func:`resize_linear`).

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


# ------------------------------------------------------------------ resize

INTER_RESIZE_COEF_SCALE = 2048  # OpenCV's 11-bit fixed-point weights


def _check_image(img: np.ndarray, dtypes: tuple) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype not in dtypes:
        raise TypeError(f"resize takes {[np.dtype(d).name for d in dtypes]}"
                        f" images, got {img.dtype.name}")
    if img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"resize takes a non-empty (H, W) or (H, W, C) "
                         f"image, got shape {img.shape}")
    return img


def _as_cv_shape(out: np.ndarray, img: np.ndarray) -> np.ndarray:
    """cv2 returns an (H, W) array for one channel, (H, W, 1) included."""
    return out[..., 0] if img.ndim == 2 or img.shape[2] == 1 else out


def _opencv_axis(n: int, m: int):
    """OpenCV's own linear table for one axis of ``n`` → ``m``: the source
    index, the float32 weights (1 - f, f) and the first output index whose
    right neighbour lies past the edge (OpenCV's ``xmax``). The position
    ``(d + 0.5) · (1 / (m / n)) - 0.5`` is rounded to float32; an index
    before the first pixel or at the last one is clamped with f = 0."""
    f = ((np.arange(m) + 0.5) * (1.0 / (m / n)) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    past = np.nonzero(s + 1 >= n)[0]
    edge = int(past[0]) if len(past) else m
    clamp = (s < 0) | (s >= n - 1)
    f[clamp] = 0
    s = np.clip(s, 0, n - 1)
    return s, np.float32(1) - f, f, edge


def _ipp_axis(n: int, m: int):
    """IPP's linear table for one axis: the position ``(d + 0.5) · n / m -
    0.5`` in float64, its fraction rounded to float32, clamped at both
    edges with t = 0. Returns (left index, right index, t)."""
    f = (np.arange(m) + 0.5) * (n / m) - 0.5
    s = np.floor(f)
    t = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    t[(s < 0) | (s >= n - 1)] = 0
    s = np.clip(s, 0, n - 1)
    return s, np.minimum(s + 1, n - 1), t


def _ipp_unfused(n: int, m: int, cn: int) -> np.ndarray:
    """(m, cn) mask of the outputs whose vertical step IPP rounds after
    the product. IPP runs the clamped outer columns of each side apart
    from the interior: in runs of 16 pixels from the side's first column,
    then the rest. A 4-channel run of 16, and a rest of 5 or more pixels
    (all 4 channels; the first two of 3), go through code that does not
    fuse; 1-channel images and rests under 5 pixels fuse throughout."""
    f = np.floor((np.arange(m) + 0.5) * (n / m) - 0.5)
    mask = np.zeros((m, cn), bool)
    channels = {3: 2, 4: 4}.get(cn, 0)
    for start, w in ((0, int((f < 0).sum())),
                     (m - int((f >= n - 1).sum()), int((f >= n - 1).sum()))):
        runs = w // 16 * 16
        if cn == 4:
            mask[start:start + runs] = True
        if w - runs >= 5:
            mask[start + runs:start + w, :channels] = True
    return mask


def _resize_ipp(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """IPP's ``ippiResizeLinear`` on uint16 or float32: rows first, then
    columns, each a float32 ``fma(t, b - a, a)`` (the vertical step of
    the outer columns in :func:`_ipp_unfused` rounded after the product);
    uint16 rounds half to even and saturates."""
    a = img.astype(np.float32)
    s0, s1, t = _ipp_axis(img.shape[1], width)
    a = fma32(t[None, :, None], a[:, s1] - a[:, s0], a[:, s0])
    s0, s1, t = _ipp_axis(img.shape[0], height)
    t = t[:, None, None]
    d = a[s1] - a[s0]
    a = np.where(_ipp_unfused(img.shape[1], width, img.shape[2]),
                 a[s0] + t * d, fma32(t, d, a[s0]))
    if img.dtype == np.uint16:
        return np.clip(np.rint(a), 0, 65535).astype(np.uint16)
    return a


def _resize_half(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``INTER_AREA`` fast path for an exact 2× downsample (which
    ``INTER_LINEAR`` takes too): integers with 1, 3 or 4 channels round
    ``(sum + 2) >> 2``; other channel counts multiply the sum by 0.25f and
    round half to even; float32 sums the four in row order."""
    h, w, cn = img.shape
    q = img.reshape(h // 2, 2, w // 2, 2, cn)
    p00, p01, p10, p11 = q[:, 0, :, 0], q[:, 0, :, 1], q[:, 1, :, 0], \
        q[:, 1, :, 1]
    if img.dtype == np.float32:
        return ((p00 + p01) + p10 + p11) * np.float32(0.25)
    total = p00.astype(np.int64) + p01 + p10 + p11
    if cn in (1, 3, 4):
        return ((total + 2) >> 2).astype(img.dtype)
    return np.rint(total.astype(np.float32) * np.float32(0.25)).astype(
        img.dtype)


def _resize_opencv(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """OpenCV's separable linear resize (``resizeGeneric_``). uint8 works
    in 11-bit fixed point: the row pass sums ``pixel · weight`` exactly,
    the column pass as OpenCV's vector code rounds it,
    ``((b0 · (r0 >> 4)) >> 16) + ((b1 · (r1 >> 4)) >> 16) + 2 >> 2``.
    uint16 and float32 work in float32, ``a · w0 + b · w1`` rounded after
    each product, uint16 rounded half to even and saturated. Outputs past
    ``xmax`` copy the last source column; rows above the first or below
    the last are the edge row taken twice with their unclamped weights."""
    sh, sw = img.shape[:2]
    xs, xw0, xw1, xmax = _opencv_axis(sw, width)
    fy = ((np.arange(height) + 0.5) * (1.0 / (height / sh)) - 0.5).astype(
        np.float32)
    y0 = np.floor(fy)
    yw1 = fy - y0
    yw0 = np.float32(1) - yw1
    y0 = y0.astype(np.int64)
    r0, r1 = np.clip(y0, 0, sh - 1), np.clip(y0 + 1, 0, sh - 1)
    xs1 = np.minimum(xs + 1, sw - 1)
    ex, ey = (None, slice(None), None), (slice(None), None, None)
    if img.dtype == np.uint8:
        one = np.float32(INTER_RESIZE_COEF_SCALE)
        ax0, ax1 = (np.rint(w * one).astype(np.int64) for w in (xw0, xw1))
        by0, by1 = (np.rint(w * one).astype(np.int64) for w in (yw0, yw1))
        a = img.astype(np.int64)
        rows = a[:, xs] * ax0[ex] + a[:, xs1] * ax1[ex]
        rows[:, xmax:] = a[:, xs[xmax:]] * INTER_RESIZE_COEF_SCALE
        out = (((by0[ey] * (rows[r0] >> 4)) >> 16)
               + ((by1[ey] * (rows[r1] >> 4)) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    a = img.astype(np.float32)
    rows = a[:, xs] * xw0[ex] + a[:, xs1] * xw1[ex]
    rows[:, xmax:] = a[:, xs[xmax:]]
    out = rows[r0] * yw0[ey] + rows[r1] * yw1[ey]
    if img.dtype == np.uint16:
        return np.clip(np.rint(out), 0, 65535).astype(np.uint16)
    return out


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    on a uint8, uint16 or float32 (H, W) or (H, W, C) image. cv2 takes one
    of four routes, and so does this copy:

    - the same size: a copy;
    - uint16 or float32 with 1, 3 or 4 channels and both sides over one
      pixel: the IPP HAL's linear resize (:func:`_resize_ipp`), the exact
      2× downsample included;
    - otherwise an exact 2× downsample on both sides: the ``INTER_AREA``
      fast path (:func:`_resize_half`);
    - otherwise OpenCV's own separable resize (:func:`_resize_opencv`),
      in fixed point for uint8."""
    img = _check_image(img, (np.uint8, np.uint16, np.float32))
    a = img if img.ndim == 3 else img[..., None]
    sh, sw, cn = a.shape
    if (sh, sw) == (height, width):
        return _as_cv_shape(a.copy(), img)
    if img.dtype != np.uint8 and cn in (1, 3, 4) and sh > 1 and sw > 1:
        out = _resize_ipp(a, width, height)
    elif (sh, sw) == (2 * height, 2 * width):
        out = _resize_half(a)
    else:
        out = _resize_opencv(a, width, height)
    return _as_cv_shape(out, img)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``:
    source pixel ``min(floor(x · (1 / (width / W))), W - 1)`` in float64
    (not ``INTER_NEAREST_EXACT``'s centre rule). A gather, so exact for
    every dtype; cv2 returns (H, W) for one channel."""
    img = np.asarray(img)
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / sw))),
                    sw - 1).astype(np.int64)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / sh))),
                    sh - 1).astype(np.int64)
    out = img[ys[:, None], xs[None, :]]
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out
