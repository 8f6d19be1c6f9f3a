"""The numbers that decide ``correct``: gaps between the program's outputs
and the reference's on the same inputs.

- ``max_gap``, ``mean_gap``: the widest and the mean absolute gap of a
  float field.
- ``mask_disagree_pct``: of the pixels that either side labels, the share
  not covered by a pair of instances that are each other's best overlap.
- ``class_disagree_pct``: of those mutual pairs, the share whose classes
  differ.
- ``cells_mismatch_pct``: cells as points (centroid and class): the
  reference's cells with no program cell of the same class within
  ``tol`` px, plus the program's cells with no reference cell so, over
  the reference's count.
"""

from __future__ import annotations

import numpy as np


def max_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def mean_gap(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def mutual_pairs(p: np.ndarray, r: np.ndarray):
    """(pairs of instance ids (program, reference) that are each other's
    largest overlap, the pixels either side labels)."""
    p, r = p.ravel().astype(np.int64), r.ravel().astype(np.int64)
    both = (p > 0) & (r > 0)
    np_, nr = int(p.max()) + 1, int(r.max()) + 1
    ov = np.bincount(p[both] * nr + r[both], minlength=np_ * nr).reshape(
        np_, nr)
    best_r = ov.argmax(1)
    best_p = ov.argmax(0)
    pairs = [(i, int(best_r[i])) for i in range(1, np_)
             if ov[i, best_r[i]] > 0 and best_p[best_r[i]] == i]
    return pairs, int(((p > 0) | (r > 0)).sum())


def mask_disagree_pct(p: np.ndarray, r: np.ndarray) -> float:
    pairs, labelled = mutual_pairs(p, r)
    if labelled == 0:
        return 0.0
    pf, rf = p.ravel(), r.ravel()
    good = np.zeros(int(p.max()) + 1, np.int64)
    for i, j in pairs:
        good[i] = j
    agree = int(((pf > 0) & (rf > 0) & (good[pf] == rf)).sum())
    return 100.0 * (1.0 - agree / labelled)


def class_disagree_pct(p, r, p_cls, r_cls) -> float:
    """Over mutual pairs: share whose class (read at the instance's first
    pixel in each side's class map) differs."""
    pairs, _ = mutual_pairs(p, r)
    if not pairs:
        return 0.0
    pc = instance_values(p, p_cls)
    rc = instance_values(r, r_cls)
    bad = sum(pc[i] != rc[j] for i, j in pairs)
    return float(100.0 * bad / len(pairs))


def instance_values(masks: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Per instance id, ``values`` at its raster-first pixel."""
    m = masks.ravel()
    out = np.zeros(int(m.max()) + 1, np.int64)
    idx = np.flatnonzero(m)
    first = np.unique(m[idx], return_index=True)
    out[first[0]] = values.ravel()[idx[first[1]]]
    return out


def cells_from_masks(masks: np.ndarray, class_masks: np.ndarray,
                     origin, scale: float) -> np.ndarray:
    """(n, 3) float: slide x, slide y and class of each instance's pixel
    centroid."""
    m = masks.ravel().astype(np.int64)
    n = np.bincount(m)
    H, W = masks.shape
    yy, xx = np.divmod(np.arange(H * W), W)
    cy = np.bincount(m, weights=yy) / np.maximum(n, 1)
    cx = np.bincount(m, weights=xx) / np.maximum(n, 1)
    ids = np.flatnonzero(n[1:]) + 1
    cls = instance_values(masks, class_masks)
    return np.stack([cx[ids] * scale + origin[0],
                     cy[ids] * scale + origin[1], cls[ids]], axis=1)


def cells_mismatch_pct(ref: np.ndarray, got: np.ndarray, box, tol: float
                       ) -> tuple[float, int]:
    """``ref`` and ``got`` (n, 3) cells. The reference's cells inside
    ``box`` (x0, y0, x1, y1) that no program cell of the same class lies
    within ``tol`` of, plus the program's cells inside the box that match
    no reference cell, over the reference's count in the box. Returns
    (the percentage, that count)."""
    def within(c, pad):
        return c[(c[:, 0] >= box[0] - pad) & (c[:, 0] < box[2] + pad)
                 & (c[:, 1] >= box[1] - pad) & (c[:, 1] < box[3] + pad)]

    ref_in = within(ref, 0.0)
    # a program cell just outside the box can match a reference cell
    # just inside it, and the other way round
    got_near, ref_near = within(got, tol), within(ref, tol)
    got_in = within(got, 0.0)

    def matched(a, b):
        if len(a) == 0 or len(b) == 0:
            return np.zeros(len(a), bool)
        d = np.hypot(a[:, None, 0] - b[None, :, 0],
                     a[:, None, 1] - b[None, :, 1])
        return ((d <= tol) & (a[:, None, 2] == b[None, :, 2])).any(1)

    missed = int((~matched(ref_in, got_near)).sum())
    extra = int((~matched(got_in, ref_near)).sum())
    if len(ref_in) == 0:
        return (0.0 if extra == 0 else 100.0), 0
    return 100.0 * (missed + extra) / len(ref_in), len(ref_in)
