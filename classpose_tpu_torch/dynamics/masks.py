"""Instance masks from predicted flow fields (counterpart of
``classpose_tpu/dynamics/masks.py``).

1. ``follow_flows_batched``: every pixel follows ``dP·iscell/5`` for
   exactly ``niter`` Euler steps by binary flow-map composition (the
   one-step map clamped to ±``STEP_CAP`` px, positions clipped to the
   image); each composition pass is one bilinear sample (CUDA kernel on
   the card);
2. ``get_masks_from_positions_batched``: a histogram of the rounded
   landing positions (CUDA kernel), seeds at 5×5 local maxima with count
   > 10, basins grown over {count > 2} by 5 rounds of 3×3 max
   propagation, then each pixel takes the label at its landing position
   (the sampler at C=1, exact at integer positions);
3. the scatter QC ``qc_prepare`` → ``_diffuse_dyn`` → ``grad_from_T`` →
   ``qc_finish``: instances above ``max_size_fraction``·H·W are removed,
   then those whose recomputed flows disagree with the predicted ones
   (mean squared error > ``flow_threshold``);
4. on the host, ``densify_labels`` and ``fill_holes_and_remove_small_masks``.

The per-image API (``ClassposeModel.eval``) runs ``compute_masks``:
``follow_flows`` and ``get_masks_from_positions`` (the batched functions
at B = 1) on the device, then on the host the densify, the max-size
filter and the flow-error QC of ``flow_errors``, whose recomputation
(``masks_to_flows``) runs on the device.

Not ported, because they exist only to avoid TPU weaknesses: the one-hot
fused QC with its instance-count and window redo paths, the MXU seed
cumsum, the gather-free shift sampler and the displacement-bound guard.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from classpose_tpu_torch.dynamics.flows import (
    _bucket,
    _diffuse_dyn,
    _max_instance_extent,
    grad_from_T,
    masks_to_flows,
)
from classpose_tpu_torch.ops.sample import bilinear_sample, landing_histogram
from classpose_tpu_torch.tracing import span

STEP_CAP = 2.0  # max px per Euler step (binds only for |dP| > 10)


def follow_flows_batched(dP: torch.Tensor, iscell: torch.Tensor,
                         niter: int = 200) -> torch.Tensor:
    """dP (B, 2, H, W), iscell (B, H, W) bool → final positions
    (B, 2, H, W) f32 after exactly ``niter`` steps."""
    B, _, H, W = dP.shape
    dev = dP.device
    u = (dP * iscell[:, None].to(dP.dtype) / 5.0).to(torch.float32)
    u = torch.clamp(u, -STEP_CAP, STEP_CAP)
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] \
        .expand(1, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] \
        .expand(1, H, W)

    def clip_disp(dy, dx):
        return torch.stack([torch.clamp(gy + dy, 0.0, H - 1.0) - gy,
                            torch.clamp(gx + dx, 0.0, W - 1.0) - gx], dim=1)

    def sample(field, disp):
        return bilinear_sample(field.contiguous(),
                               (gy + disp[:, 0]).contiguous(),
                               (gx + disp[:, 1]).contiguous())

    u = clip_disp(u[:, 0], u[:, 1])
    niter = max(int(niter), 1)
    r = None
    k_max = niter.bit_length() - 1
    for k in range(k_max + 1):
        if (niter >> k) & 1:
            if r is None:
                r = u
            else:
                s = sample(u, r)
                r = clip_disp(r[:, 0] + s[:, 0], r[:, 1] + s[:, 1])
        if k < k_max:
            s = sample(u, u)
            u = clip_disp(u[:, 0] + s[:, 0], u[:, 1] + s[:, 1])
    return torch.stack([gy + r[:, 0], gx + r[:, 1]], dim=1)


def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k 'SAME' max over (B, H, W) f32 (the border sees only in-image
    values)."""
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def get_masks_from_positions_batched(
    p: torch.Tensor, iscell: torch.Tensor, n_expand: int = 5,
    seed_min_count: float = 10.0, basin_min_count: float = 2.0,
    return_seeds: bool = False,
):
    """(B, 2, H, W) positions, (B, H, W) foreground → (B, H, W) int32
    labels whose ids are dense seed ranks in raster order (gaps where a
    basin died); with ``return_seeds`` also the seed-id map."""
    B, _, H, W = p.shape
    fy = torch.clamp(torch.round(p[:, 0]), 0, H - 1).to(torch.int32)
    fx = torch.clamp(torch.round(p[:, 1]), 0, W - 1).to(torch.int32)
    cellf = iscell.to(torch.float32)
    h = landing_histogram(fy.contiguous(), fx.contiguous(),
                          cellf.contiguous())
    seeds = (h >= _maxpool(h, 5)) & (h > seed_min_count)
    rank = torch.cumsum(seeds.reshape(B, H * W).to(torch.int32), dim=1,
                        dtype=torch.int32).reshape(B, H, W)
    seed_lab = torch.where(seeds, rank, 0)
    grow = h > basin_min_count
    lab = seed_lab
    for _ in range(n_expand):
        lab_max = _maxpool(lab.to(torch.float32), 3).to(torch.int32)
        lab = torch.where(grow & (lab == 0), lab_max, lab)
        lab = torch.where(seeds, seed_lab, lab)
    # label lookup at the landing positions: the sampler at C=1, exact
    # because the positions are integers (weights exactly 0 or 1)
    masks = bilinear_sample(
        lab.to(torch.float32)[:, None].contiguous(),
        fy.to(torch.float32), fx.to(torch.float32),
    )[:, 0].to(torch.int32)
    masks = torch.where(iscell, masks, 0)
    if return_seeds:
        return masks, seed_lab
    return masks


def _seg(vals: torch.Tensor, gidx: torch.Tensor, size: int, init: float,
         reduce: str) -> torch.Tensor:
    """Per-instance reduction of (B, HW) ``vals`` at global ids ``gidx``."""
    out = torch.full((size,), init, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        return out.index_add_(0, gidx.reshape(-1), vals.reshape(-1))
    return out.scatter_reduce_(0, gidx.reshape(-1), vals.reshape(-1),
                               reduce, include_self=True)


def qc_prepare(raw: torch.Tensor, max_size_fraction: float = 0.4):
    """Max-size filter, extent-derived diffusion horizon, nearest-to-
    centroid centre map (lowest flat index on ties), for a (B, H, W)
    batch of raw labels. Returns (ids (B, H, W) int32, centre map
    (B, H, W) f32, niter_qc (B,) int32)."""
    B, H, W = raw.shape
    HW = H * W
    nb = HW + 2  # raw ids are at most HW
    dev = raw.device
    big = 1e9
    ids = raw.reshape(B, HW).to(torch.int64)
    off = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * nb
    size = B * nb

    def table(t):  # (B*nb,) → (B, nb)
        return t.reshape(B, nb)

    def at(tab, i):  # per-pixel lookup of a (B, nb) table
        return torch.gather(tab, 1, i)

    fg = ids > 0
    n = table(_seg(fg.float(), ids + off, size, 0.0, "sum"))
    if max_size_fraction is not None and max_size_fraction > 0:
        too_big = n > max_size_fraction * HW
        ids = torch.where(fg & ~at(too_big, ids), ids, 0)
        fg = ids > 0
        n = table(_seg(fg.float(), ids + off, size, 0.0, "sum"))
    fgf = fg.float()
    gid = ids + off
    idx = torch.arange(HW, device=dev, dtype=torch.int64)[None].expand(B, HW)
    yy = (idx // W).float()
    xx = (idx % W).float()

    ymin = table(_seg(torch.where(fg, yy, big), gid, size, big, "amin"))
    ymax = table(_seg(torch.where(fg, yy, -big), gid, size, -big, "amax"))
    xmin = table(_seg(torch.where(fg, xx, big), gid, size, big, "amin"))
    xmax = table(_seg(torch.where(fg, xx, -big), gid, size, -big, "amax"))
    present = n > 0
    present[:, 0] = False
    ext = torch.where(present,
                      torch.maximum(ymax - ymin, xmax - xmin) + 1.0, 0.0)
    niter_qc = torch.clamp(
        2.0 * torch.clamp(ext.max(dim=1).values, min=1.0), 40.0, 400.0)
    niter_qc = (40.0 * torch.ceil(niter_qc / 40.0)).to(torch.int32)

    sy = table(_seg(yy * fgf, gid, size, 0.0, "sum"))
    sx = table(_seg(xx * fgf, gid, size, 0.0, "sum"))
    cy = sy / torch.clamp(n, min=1.0)
    cx = sx / torch.clamp(n, min=1.0)
    d = torch.where(fg, (yy - at(cy, ids)) ** 2 + (xx - at(cx, ids)) ** 2,
                    big)
    dmin = table(_seg(d, gid, size, big, "amin"))
    cand = fg & (d <= at(dmin, ids))
    idxmin = table(_seg(torch.where(cand, idx, HW + 1),
                        torch.where(cand, ids, 0) + off, size, HW + 1,
                        "amin"))
    center = (cand & (idx == at(idxmin, ids))).float()
    return (ids.to(torch.int32).reshape(B, H, W),
            center.reshape(B, H, W), niter_qc)


def qc_finish(ids2d: torch.Tensor, mu: torch.Tensor, dP: torch.Tensor,
              flow_threshold: float) -> torch.Tensor:
    """Per-instance mean squared error of ``mu`` vs ``dP/5``; failing
    instances zeroed. ids2d (B, H, W), mu and dP (B, 2, H, W)."""
    B, H, W = ids2d.shape
    nb = H * W + 2
    ids = ids2d.reshape(B, H * W).to(torch.int64)
    gid = ids + torch.arange(B, device=ids.device)[:, None] * nb
    fg = ids > 0
    fgf = fg.float()
    n = _seg(fgf, gid, B * nb, 0.0, "sum").reshape(B, nb)
    err = ((mu - dP.float() / 5.0) ** 2).sum(dim=1).reshape(B, H * W)
    s = _seg(err * fgf, gid, B * nb, 0.0, "sum").reshape(B, nb)
    bad = s / torch.clamp(n, min=1.0) > flow_threshold
    bad[:, 0] = False
    keep = fg & ~torch.gather(bad, 1, ids)
    return torch.where(keep, ids, 0).to(torch.int32).reshape(B, H, W)


def qc_filter_masks(raw: torch.Tensor, dP: torch.Tensor,
                    flow_threshold: float = 0.4,
                    max_size_fraction: float = 0.4) -> torch.Tensor:
    """Device max-size filter + flow-error QC on raw (B, H, W) labels;
    returns raw labels with failing instances zeroed."""
    ids2d, center, niter_qc = qc_prepare(raw, max_size_fraction)
    if flow_threshold is None or flow_threshold <= 0:
        return ids2d
    T = _diffuse_dyn(ids2d, center, niter_qc)
    mu = grad_from_T(ids2d, T)
    return qc_finish(ids2d, mu, dP, flow_threshold)


def densify_labels(raw: np.ndarray) -> np.ndarray:
    """Sparse non-negative labels → dense 0..n, ascending (0 stays 0)."""
    raw = np.asarray(raw)
    counts = np.bincount(raw.ravel(), minlength=int(raw.max()) + 1)
    newid = np.cumsum(counts > 0, dtype=np.int32)
    if counts[0] > 0:
        newid -= 1
    newid[0] = 0
    return newid[raw]


def fill_holes_and_remove_small_masks(masks: np.ndarray, min_size: int = 15
                                      ) -> np.ndarray:
    """Fill holes per instance and drop instances below ``min_size``
    pixels, relabeling sequentially (cellpose semantics; scipy)."""
    from scipy import ndimage

    masks = np.asarray(masks)
    out = np.zeros_like(masks, dtype=np.int32)
    new_id = 1
    for i, sl in enumerate(ndimage.find_objects(masks), start=1):
        if sl is None:
            continue
        crop = masks[sl] == i
        if np.count_nonzero(crop) < max(min_size, 1):
            continue
        out[sl][ndimage.binary_fill_holes(crop)] = new_id
        new_id += 1
    return out


# ------------------------------------------------------------ per image

def follow_flows(dP: torch.Tensor, iscell: torch.Tensor, niter: int = 200
                 ) -> torch.Tensor:
    """dP (2, H, W), iscell (H, W) → final positions (2, H, W) f32: the
    batched function at B = 1."""
    return follow_flows_batched(dP[None], iscell[None], niter=niter)[0]


def get_masks_from_positions(p: torch.Tensor, iscell: torch.Tensor,
                             n_expand: int = 5, seed_min_count: float = 10.0,
                             basin_min_count: float = 2.0,
                             return_seeds: bool = False):
    """(2, H, W) positions, (H, W) foreground → (H, W) int32 labels (dense
    seed ranks with gaps); the batched function at B = 1."""
    out = get_masks_from_positions_batched(
        p[None], iscell[None], n_expand=n_expand,
        seed_min_count=seed_min_count, basin_min_count=basin_min_count,
        return_seeds=return_seeds)
    if return_seeds:
        return out[0][0], out[1][0]
    return out[0]


def flow_errors(masks, dP, max_id: int | None = None,
                niter: int | None = None, device="cuda") -> np.ndarray:
    """Per-instance mean squared error between the flows recomputed from
    ``masks`` (on ``device``) and the predicted ``dP``/5 (cellpose
    ``remove_bad_flow_masks``); (nmax+1,) float32. ``niter=None`` takes
    the horizon from the largest instance extent,
    ``bucket(min(max(2·ext, 40), 400), 40)``."""
    masks_np = np.asarray(masks)
    if niter is None:
        niter = _bucket(
            min(max(2 * _max_instance_extent(masks_np), 40), 400), 40)
    mu = masks_to_flows(masks_np, niter=niter, device=device).cpu().numpy()
    err_map = ((mu - np.asarray(dP) / 5.0) ** 2).sum(axis=0)
    ids = masks_np.ravel().astype(np.int64)
    fg = ids > 0
    nmax = int(masks_np.max()) if max_id is None else max_id
    n = np.bincount(ids[fg], minlength=nmax + 1)
    s = np.bincount(ids[fg], weights=err_map.ravel()[fg],
                    minlength=nmax + 1)
    return (s / np.maximum(n, 1)).astype(np.float32)


def compute_masks(dP, cellprob, niter: int = 200,
                  cellprob_threshold: float = 0.0,
                  flow_threshold: float = 0.4, min_size: int = 15,
                  max_size_fraction: float = 0.4, qc_niter: int | None = None,
                  qc_downsample: int = 1, device="cuda") -> np.ndarray:
    """Mask recovery for one (2, H, W) flow field and (H, W) cellprob
    (numpy or tensors) → (H, W) int32. ``qc_downsample = d > 1`` runs the
    flow QC on every d-th pixel (an approximation the JAX signature
    offers); ``qc_niter`` fixes its horizon. Its stages run under the
    spans ``masks.follow``, ``.labels``, ``.max_size``, ``.qc`` and
    ``.holes``."""
    dP = torch.as_tensor(dP, dtype=torch.float32, device=device)
    cellprob = torch.as_tensor(cellprob, dtype=torch.float32, device=device)
    with span("masks.follow"):
        iscell = cellprob > cellprob_threshold
        if not bool(iscell.any()):
            return np.zeros(tuple(cellprob.shape), np.int32)
        p = follow_flows(dP.contiguous(), iscell, niter=niter)
    with span("masks.labels"):
        masks = densify_labels(
            get_masks_from_positions(p, iscell).cpu().numpy())
        nmax = int(masks.max())
    if nmax == 0:
        return masks
    with span("masks.max_size"):  # cellpose get_masks tail
        counts = np.bincount(masks.ravel(), minlength=nmax + 1)
        H, W = masks.shape
        too_big = counts > max_size_fraction * H * W
        too_big[0] = False
        if too_big.any():
            masks[too_big[masks]] = 0
            masks = densify_labels(masks)
            nmax = int(masks.max())
            if nmax == 0:
                return masks
    if flow_threshold is not None and flow_threshold > 0:
        with span("masks.qc"):
            d = max(1, int(qc_downsample))
            errs = flow_errors(masks[::d, ::d], dP.cpu().numpy()[:, ::d, ::d],
                               max_id=nmax, niter=qc_niter, device=device)
            bad = errs > flow_threshold
            bad[0] = False
            if bad.any():
                masks[bad[masks]] = 0
    with span("masks.holes"):
        return fill_holes_and_remove_small_masks(masks, min_size=min_size)
