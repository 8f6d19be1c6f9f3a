"""Instance masks from flow fields, in plain PyTorch and numpy.

Frozen copy of the plain versions in ``classpose_tpu_torch/dynamics/``
(``masks.py``, ``flows.py``) and ``classpose_tpu_torch/ops/`` (the plain
bilinear sampler, landing histogram and masked diffusion of
``sample.py`` and ``diffusion.py``), with the kernels' wrappers left out:
every function here runs on whatever device its tensors are on, with
no kernel of the program.

1. Every foreground pixel follows ``dP/5`` for ``niter`` Euler steps by
   binary composition of the one-step map (clamped to ±2 px, positions
   clipped to the image), each composition one bilinear sample.
2. A histogram of the rounded landing positions; seeds at 5×5 maxima
   with count > 10; basins grown over {count > 2} by 5 rounds of 3×3
   max propagation; each pixel takes the label at its landing position.
3. QC: instances above ``max_size_fraction`` of the tile go; then the
   flows recomputed from the labels (heat diffusion from each instance's
   centre, gradient of log1p) are held to ``dP/5``, and instances whose
   mean squared error exceeds ``flow_threshold`` go.
4. On the host: dense ids, holes filled, instances under ``min_size``
   dropped, and each instance's majority class.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

STEP_CAP = 2.0
NINTH = 1.0 / 9.0
SHIFTS9 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def bilinear_sample(u, py, px):
    """(B, C, H, W) sampled at (B, H, W) positions: x-lerp on rows y0 and
    y0 + 1, then y-lerp; y0 = clip(floor(py), 0, H − 2)."""
    B, C, H, W = u.shape
    y0 = torch.clamp(torch.floor(py), 0, H - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(px), 0, W - 2).to(torch.int64)
    wy = (py - y0.to(py.dtype))[:, None]
    wx = (px - x0.to(px.dtype))[:, None]
    flat = u.reshape(B, C, H * W)
    base = (y0 * W + x0).reshape(B, 1, H * W).expand(B, C, H * W)

    def at(off):
        return torch.gather(flat, 2, base + off).reshape(B, C, H, W)

    g0 = (1 - wx) * at(0) + wx * at(1)
    g1 = (1 - wx) * at(W) + wx * at(W + 1)
    return (1 - wy) * g0 + wy * g1


def follow_flows(dP, iscell, niter=200):
    """dP (B, 2, H, W), iscell (B, H, W) → positions (B, 2, H, W)."""
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


def _maxpool(x, k):
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def masks_from_positions(p, iscell, n_expand=5, seed_min_count=10.0,
                         basin_min_count=2.0):
    """(B, 2, H, W) positions, (B, H, W) foreground → (B, H, W) int32."""
    B, _, H, W = p.shape
    fy = torch.clamp(torch.round(p[:, 0]), 0, H - 1).to(torch.int64)
    fx = torch.clamp(torch.round(p[:, 1]), 0, W - 1).to(torch.int64)
    flat = (torch.arange(B, device=p.device)[:, None, None] * (H * W)
            + fy * W + fx)
    h = torch.zeros(B * H * W, dtype=torch.float32, device=p.device)
    h.index_add_(0, flat.reshape(-1), iscell.to(torch.float32).reshape(-1))
    h = h.reshape(B, H, W)
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
    masks = torch.gather(lab.reshape(B, H * W), 1,
                         (fy * W + fx).reshape(B, H * W)).reshape(B, H, W)
    return torch.where(iscell, masks, 0).to(torch.int32)


def _seg(vals, gidx, size, init, reduce):
    out = torch.full((size,), init, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        return out.index_add_(0, gidx.reshape(-1), vals.reshape(-1))
    return out.scatter_reduce_(0, gidx.reshape(-1), vals.reshape(-1),
                               reduce, include_self=True)


def qc_prepare(raw, max_size_fraction=0.4):
    """Max-size filter, the diffusion horizon from the largest extent, and
    the nearest-to-centroid centre map (lowest index on ties)."""
    B, H, W = raw.shape
    HW = H * W
    nb = HW + 2
    dev = raw.device
    big = 1e9
    ids = raw.reshape(B, HW).to(torch.int64)
    off = torch.arange(B, device=dev, dtype=torch.int64)[:, None] * nb
    size = B * nb

    def table(t):
        return t.reshape(B, nb)

    def at(tab, i):
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


def diffuse(ids, center, niter):
    """Tile b runs ``niter[b]`` iterations from zero of
    ``T ← where(ids > 0, Σ_{same-id 3×3 nbrs}(T + cen)·(1/9), 0)``."""
    B, H, W = ids.shape
    ids_p = F.pad(ids, (1, 1, 1, 1))
    fg = ids > 0
    cen = center * fg
    ninth = torch.tensor(NINTH, dtype=torch.float32, device=ids.device)
    T = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    nmax = int(niter.max()) if niter.numel() else 0
    for it in range(nmax):
        Tp = F.pad(T + cen, (1, 1, 1, 1))
        acc = torch.zeros_like(T)
        for dy, dx in SHIFTS9:
            nb_T = Tp[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            nb_id = ids_p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            acc = acc + torch.where(nb_id == ids, nb_T, 0.0)
        new = torch.where(fg, acc * ninth, 0.0)
        T = torch.where((it < niter)[:, None, None], new, T)
    return T


def grad_from_T(masks, T):
    H, W = masks.shape[-2:]
    fg = masks.to(torch.int32) > 0
    Tp = F.pad(torch.log1p(T), (1, 1, 1, 1))
    dy = (Tp[..., 2:2 + H, 1:1 + W] - Tp[..., 0:H, 1:1 + W]) / 2.0
    dx = (Tp[..., 1:1 + H, 2:2 + W] - Tp[..., 1:1 + H, 0:W]) / 2.0
    mag = torch.sqrt(dy ** 2 + dx ** 2)
    mu = torch.stack([dy, dx], dim=-3) / torch.clamp(mag, min=1e-20)[
        ..., None, :, :]
    return torch.where(fg[..., None, :, :], mu, 0.0).to(torch.float32)


def qc_finish(ids2d, mu, dP, flow_threshold):
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


def qc_filter(raw, dP, flow_threshold=0.4, max_size_fraction=0.4):
    ids2d, center, niter_qc = qc_prepare(raw, max_size_fraction)
    if flow_threshold is None or flow_threshold <= 0:
        return ids2d
    mu = grad_from_T(ids2d, diffuse(ids2d, center, niter_qc))
    return qc_finish(ids2d, mu, dP, flow_threshold)


def densify(raw: np.ndarray) -> np.ndarray:
    raw = np.asarray(raw)
    counts = np.bincount(raw.ravel(), minlength=int(raw.max()) + 1)
    newid = np.cumsum(counts > 0, dtype=np.int32)
    if counts[0] > 0:
        newid -= 1
    newid[0] = 0
    return newid[raw]


def fill_holes_and_remove_small(masks: np.ndarray, min_size: int = 15
                                ) -> np.ndarray:
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


def class_vote(masks: np.ndarray, pixel_cls: np.ndarray, n_classes: int
               ) -> np.ndarray:
    """Each instance's majority class over a pixelwise argmax map."""
    if not masks.max():
        return np.zeros_like(masks, dtype=np.int32)
    inst = masks.ravel()
    cls = pixel_cls.ravel().astype(np.int64)
    valid = inst > 0
    idx = inst[valid].astype(np.int64) * n_classes + cls[valid]
    counts = np.bincount(idx, minlength=(int(inst.max()) + 1) * n_classes)
    major = counts.reshape(-1, n_classes).argmax(axis=1)
    major[0] = 0
    return major[masks].astype(np.int32)


# ------------------------------------------------------------ per image

def instance_center_map(masks: np.ndarray) -> np.ndarray:
    masks = np.asarray(masks)
    H, W = masks.shape
    ids = masks.ravel().astype(np.int64)
    fg = ids > 0
    out = np.zeros(H * W, np.float32)
    if not fg.any():
        return out.reshape(H, W)
    n = np.bincount(ids)
    yy, xx = np.divmod(np.arange(H * W, dtype=np.int64), W)
    cy = np.bincount(ids, weights=yy) / np.maximum(n, 1)
    cx = np.bincount(ids, weights=xx) / np.maximum(n, 1)
    d = (yy - cy[ids]) ** 2 + (xx - cx[ids]) ** 2
    d[~fg] = np.inf
    order = np.lexsort((np.arange(H * W), d, ids))
    sorted_ids = ids[order]
    first = np.ones(len(order), bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    out[order[first & (sorted_ids > 0)]] = 1.0
    return out.reshape(H, W)


def _bucket(v: int, q: int) -> int:
    return int(q * np.ceil(max(v, 1) / q))


def _max_extent(masks: np.ndarray) -> int:
    ext = 1
    for sl in ndimage.find_objects(masks):
        if sl is not None:
            ext = max(ext, sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
    return int(ext)


def flow_errors(masks: np.ndarray, dP: np.ndarray, nmax: int, device
                ) -> np.ndarray:
    niter = _bucket(min(max(2 * _max_extent(masks), 40), 400), 40)
    m = torch.as_tensor(np.ascontiguousarray(masks, np.int32), device=device)
    c = torch.as_tensor(instance_center_map(masks), device=device)
    n = torch.full((1,), niter, dtype=torch.int32, device=device)
    mu = grad_from_T(m, diffuse(m[None], c[None], n)[0]).cpu().numpy()
    err = ((mu - dP / 5.0) ** 2).sum(axis=0)
    ids = masks.ravel().astype(np.int64)
    fg = ids > 0
    cnt = np.bincount(ids[fg], minlength=nmax + 1)
    s = np.bincount(ids[fg], weights=err.ravel()[fg], minlength=nmax + 1)
    return (s / np.maximum(cnt, 1)).astype(np.float32)


def compute_masks(dP: torch.Tensor, cellprob: torch.Tensor, niter=200,
                  cellprob_threshold=0.0, flow_threshold=0.4, min_size=15,
                  max_size_fraction=0.4) -> np.ndarray:
    """The per-image route: (2, H, W) flows and (H, W) cellprob → (H, W)
    int32 masks (the QC on the host's dense labels)."""
    iscell = cellprob > cellprob_threshold
    if not bool(iscell.any()):
        return np.zeros(tuple(cellprob.shape), np.int32)
    p = follow_flows(dP[None].contiguous(), iscell[None], niter)
    masks = densify(masks_from_positions(p, iscell[None])[0].cpu().numpy())
    nmax = int(masks.max())
    if nmax == 0:
        return masks
    counts = np.bincount(masks.ravel(), minlength=nmax + 1)
    H, W = masks.shape
    too_big = counts > max_size_fraction * H * W
    too_big[0] = False
    if too_big.any():
        masks[too_big[masks]] = 0
        masks = densify(masks)
        nmax = int(masks.max())
        if nmax == 0:
            return masks
    if flow_threshold is not None and flow_threshold > 0:
        bad = flow_errors(masks, dP.cpu().numpy(), nmax, dP.device) \
            > flow_threshold
        bad[0] = False
        if bad.any():
            masks[bad[masks]] = 0
    return fill_holes_and_remove_small(masks, min_size)
