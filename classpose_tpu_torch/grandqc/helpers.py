"""GrandQC helpers (counterpart of ``classpose_tpu/grandqc/helpers.py``):
JPEG simulation, thumbnails, patch grids, components, region borders.

The JAX package calls OpenCV for five of these; this package has no cv2
and reproduces each bit for bit:

- ``cv2.imencode``/``imdecode`` at quality 80: the package's own JPEG
  codec (``io/jpeg.py``), whose streams and pixels are libjpeg's;
- ``cv2.resize`` with ``INTER_AREA`` (:func:`resize_area`): OpenCV's
  integer-factor block mean, its fractional area table with float32
  accumulation and round-half-even, or, where a side grows (a slide
  coarser than the model's MPP), its fixed-point bilinear rule;
- ``cv2.resize`` with ``INTER_NEAREST``: ``transforms/cvlite.py``
  :func:`resize_nearest`;
- ``cv2.connectedComponents`` (8-connected): ``scipy.ndimage.label``;
- ``cv2.findContours(RETR_CCOMP, CHAIN_APPROX_SIMPLE)`` and
  ``cv2.contourArea``: ``geometry/contours.py``.
"""

from __future__ import annotations

import math
import uuid

import numpy as np
from scipy import ndimage

from classpose_tpu_torch.geometry.contours import (
    contour_area,
    find_contours_ccomp,
)
from classpose_tpu_torch.io import jpeg
from classpose_tpu_torch.log import get_logger
from classpose_tpu_torch.utils import get_slide_resolution

logger = get_logger(__name__)

PATCH_SIZE = 512
_ROWS_PER_CHUNK = 256  # output rows of resize_area's float32 work at once


def simulate_jpeg_compression(img: np.ndarray, quality: int = 80
                              ) -> np.ndarray:
    """Encode and decode through JPEG, the QC models' training domain."""
    return jpeg.decode(jpeg.encode(img, quality))


def _area_table(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` as (dsize, T) source indices and
    float32 weights, padded with weight 0."""
    rows = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        r = []
        if sx1 - fsx1 > 1e-3:
            r.append((sx1 - 1, (sx1 - fsx1) / cell))
        r.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            r.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(r)
    T = max(len(r) for r in rows)
    idx = np.zeros((dsize, T), np.int64)
    w = np.zeros((dsize, T), np.float32)
    for dx, r in enumerate(rows):
        for t, (s, a) in enumerate(r):
            idx[dx, t] = s
            w[dx, t] = np.float32(a)
    return idx, w


def _linear_table(ssize: int, dsize: int):
    """cv2's INTER_AREA-as-bilinear coefficients for one axis: source
    index, 11-bit weights (round half to even of float32 products), and
    the first output index clamped to the last source pixel."""
    inv = dsize / ssize
    scale = 1.0 / inv
    idx = np.empty(dsize, np.int64)
    w = np.empty((dsize, 2), np.int64)
    clamp_from = dsize
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0) if f <= 0 else np.float32(f - np.floor(f))
        if s + 1 >= ssize:
            clamp_from = min(clamp_from, d)
            if s >= ssize - 1:
                f, s = np.float32(0), ssize - 1
        idx[d] = s
        w[d, 0] = int(np.rint((np.float32(1) - f) * np.float32(2048)))
        w[d, 1] = int(np.rint(f * np.float32(2048)))
    return idx, w, clamp_from


def _resize_area_enlarging(img: np.ndarray, width: int, height: int
                           ) -> np.ndarray:
    """cv2's INTER_AREA where either side grows: bilinear with area
    weights in 11-bit fixed point, the vertical pass as cv2's vector code
    rounds it (each row sum >> 4, times its weight >> 16, summed, + 2 >> 2)."""
    sh, sw = img.shape[:2]
    chan = img.shape[2:]
    xi, xw, xc = _linear_table(sw, width)
    yi, yw, _ = _linear_table(sh, height)
    ex = (None, slice(None)) + (None,) * len(chan)
    src = img.astype(np.int64)
    rows = (src[:, xi] * xw[:, 0][ex]
            + src[:, np.minimum(xi + 1, sw - 1)] * xw[:, 1][ex])
    rows[:, xc:] = src[:, xi[xc:]] * 2048
    ey = (slice(None),) + (None,) * (1 + len(chan))

    def term(r, b):
        return (np.clip(r >> 4, -32768, 32767) * b[ey]) >> 16

    out = (term(rows[yi], yw[:, 0]) + term(rows[np.minimum(yi + 1, sh - 1)],
                                           yw[:, 1]) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    for a uint8 (H, W) or (H, W, C) image."""
    sh, sw = img.shape[:2]
    sx, sy = 1.0 / (width / sw), 1.0 / (height / sh)
    if sx < 1.0 or sy < 1.0:
        return _resize_area_enlarging(img, width, height)
    kx, ky = int(round(sx)), int(round(sy))
    eps = np.finfo(np.float64).eps
    chan = img.shape[2:]
    if abs(sx - kx) < eps and abs(sy - ky) < eps:
        # integer factors: a block mean; cv2's 2×2 vector path rounds
        # (sum + 2) >> 2, the others multiply by float32 1/area and round
        # half to even
        blocks = img[: height * ky, : width * kx].astype(np.int32).reshape(
            (height, ky, width, kx) + chan).sum((1, 3))
        if kx == ky == 2:
            return ((blocks + 2) >> 2).astype(np.uint8)
        v = blocks.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    xi, xw = _area_table(sw, width, sx)
    yi, yw = _area_table(sh, height, sy)
    ex = (slice(None),) + (None,) * len(chan)
    out = np.empty((height, width) + chan, np.uint8)
    for r0 in range(0, height, _ROWS_PER_CHUNK):
        r1 = min(height, r0 + _ROWS_PER_CHUNK)
        rows = np.unique(yi[r0:r1])
        src = img[rows]
        # horizontal pass over the source rows this chunk reads, each
        # output column accumulating its terms in order (float32)
        buf = np.zeros((len(rows), width) + chan, np.float32)
        for t in range(xi.shape[1]):
            buf += src[:, xi[:, t]].astype(np.float32) * xw[:, t][ex]
        pos = np.searchsorted(rows, yi[r0:r1])
        acc = np.zeros((r1 - r0, width) + chan, np.float32)
        for t in range(yi.shape[1]):
            acc += yw[r0:r1, t][(slice(None), None) + (None,) * len(chan)] \
                * buf[pos[:, t]]
        out[r0:r1] = np.clip(np.rint(acc), 0, 255)
    return out


def extract_slide_thumbnail(
    slide, mpp_target: float
) -> tuple[np.ndarray, float, tuple[float, float]]:
    """Read a whole-slide thumbnail at ``mpp_target`` µm/px.

    Returns (rgb, scale_to_level0, slide_mpp): multiply thumbnail coords
    by ``scale_to_level0`` for level-0 coordinates."""
    mpp = get_slide_resolution(slide)
    if mpp is None:
        raise ValueError("slide has no resolvable MPP")
    downsample = mpp_target / mpp[0]
    W0, H0 = slide.level_dimensions[0]
    tw, th = max(1, int(W0 / downsample)), max(1, int(H0 / downsample))
    level = slide.get_best_level_for_downsample(downsample)
    lw, lh = slide.level_dimensions[level]
    region = slide.read_region((0, 0), level, (lw, lh))
    arr = np.asarray(region)[..., :3]
    return resize_area(arr, tw, th), downsample, mpp


def iter_patches(img: np.ndarray, patch: int = PATCH_SIZE):
    """Yield (y, x, patch) over a grid with edge-overhang re-cropping from
    the image borders: edge patches are shifted inward so every patch is
    exactly patch²."""
    H, W = img.shape[:2]
    ys = list(range(0, max(H - patch, 0) + 1, patch)) or [0]
    xs = list(range(0, max(W - patch, 0) + 1, patch)) or [0]
    if H > patch and ys[-1] + patch < H:
        ys.append(H - patch)
    if W > patch and xs[-1] + patch < W:
        xs.append(W - patch)
    for y in ys:
        for x in xs:
            yy, xx = min(y, max(H - patch, 0)), min(x, max(W - patch, 0))
            p = img[yy : yy + patch, xx : xx + patch]
            if p.shape[0] < patch or p.shape[1] < patch:
                canvas = np.full((patch, patch) + p.shape[2:], 255, p.dtype)
                canvas[: p.shape[0], : p.shape[1]] = p
                p = canvas
            yield yy, xx, p


def predict_mask(
    img: np.ndarray,
    predict_fn,
    patch: int = PATCH_SIZE,
    patch_filter=None,
    fill_value: int = 0,
    batch_size: int = 8,
) -> np.ndarray:
    """Tile ``img`` into patches, run ``predict_fn`` (batched, returns
    argmax class maps), reassemble. ``patch_filter(y, x, patch) -> bool``
    can skip patches (artefact model: <50 tissue pixels)."""
    H, W = img.shape[:2]
    out = np.full((H, W), fill_value, np.int32)
    batch, coords = [], []

    def flush():
        if not batch:
            return
        preds = predict_fn(np.stack(batch))
        for (y, x), pm in zip(coords, preds):
            h = min(patch, H - y)
            w = min(patch, W - x)
            out[y : y + h, x : x + w] = pm[:h, :w]
        batch.clear()
        coords.clear()

    for y, x, p in iter_patches(img, patch):
        if patch_filter is not None and not patch_filter(y, x, p):
            continue
        batch.append(p)
        coords.append((y, x))
        if len(batch) >= batch_size:
            flush()
    flush()
    return out


def filter_components_by_area(
    mask: np.ndarray, min_area_um2: float, mpp: float
) -> np.ndarray:
    """Remove 8-connected components below ``min_area_um2``."""
    if min_area_um2 <= 0:
        return mask.astype(np.uint8)
    labels, n = ndimage.label(mask.astype(np.uint8) != 0,
                              structure=np.ones((3, 3), bool))
    min_px = min_area_um2 / (mpp * mpp)
    counts = np.bincount(labels.ravel(), minlength=n + 1)
    keep = counts >= min_px
    keep[0] = False
    return keep[labels].astype(np.uint8)


def contours_with_holes(
    mask: np.ndarray, min_area_px: float = 0.0
) -> list[tuple[np.ndarray, list[np.ndarray]]]:
    """RETR_CCOMP region borders: [(exterior, [holes...])], both as
    (N, 2) float64 arrays, in cv2's order."""
    contours, hierarchy = find_contours_ccomp(mask)
    out = []
    for i, cnt in enumerate(contours):
        if hierarchy[i][3] != -1:  # is a hole
            continue
        if contour_area(cnt) < min_area_px or len(cnt) < 3:
            continue
        holes = []
        child = hierarchy[i][2]
        while child != -1:
            hc = contours[child]
            if len(hc) >= 3:
                holes.append(hc.astype(np.float64))
            child = hierarchy[child][0]
        out.append((cnt.astype(np.float64), holes))
    return out


def contours_to_geojson_features(
    contour_list,
    scale_to_level0: float,
    class_name: str,
    color=None,
) -> list[dict]:
    """Contours → GeoJSON Polygon features in level-0 coordinates."""
    feats = []
    for exterior, holes in contour_list:
        rings = []
        for ring in [exterior, *holes]:
            r = (ring * scale_to_level0).tolist()
            if r and r[0] != r[-1]:
                r.append(list(r[0]))
            rings.append(r)
        feats.append(
            {
                "type": "Feature",
                "id": str(uuid.uuid4()),
                "geometry": {"type": "Polygon", "coordinates": rings},
                "properties": {
                    "objectType": "annotation",
                    "isLocked": False,
                    "classification": {
                        "name": class_name,
                        "color": color or [0, 128, 0],
                    },
                },
            }
        )
    return feats


ARTEFACT_CLASS_NAMES = {
    2: "Fold",
    3: "Darkspot & Foreign Object",
    4: "Pen Marking",
    5: "Edge & Air Bubble",
    6: "Out of Focus",
}

ARTEFACT_CLASS_COLORS = {
    2: [255, 0, 0],
    3: [128, 0, 128],
    4: [0, 0, 255],
    5: [255, 165, 0],
    6: [0, 255, 255],
}
