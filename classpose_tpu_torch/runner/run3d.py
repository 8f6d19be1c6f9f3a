"""3D segmentation: orthogonal-plane flow aggregation, IoU plane
stitching and 3D mask recovery (counterpart of
``classpose_tpu/runner/run3d.py``).

- ``run_3D`` (reference core.py:234-312): the 2D net over the YX, ZY and
  ZX plane stacks, flow components summed into a 3D field [dZ, dY, dX,
  cellprob] (class channels summed the same way);
- ``stitch3D`` (cellpose utils): 2D masks linked across consecutive
  planes when IoU > ``stitch_threshold``;
- ``compute_masks_3d``: the 2D dynamics lifted one dimension, in plain
  PyTorch on the device: trilinear flow-map squaring, a 3D landing
  histogram, seeds at 3×5×5 maxima, 3×3×3 label propagation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from classpose_tpu_torch.metrics.utils import pairwise_iou_matrix
from classpose_tpu_torch.runner.core import run_net


def run_3D(net, imgs: np.ndarray, n_cell_classes: int = 1,
           batch_size: int = 8, augment: bool = False,
           tile_overlap: float = 0.1, bsize: int = 256):
    """The network over a (Lz, Ly, Lx, nchan) stack in three plane orders,
    flow components summed (reference core.py:270-312). Returns (yf (Lz,
    Ly, Lx, 4): three summed flow components and the summed cellprob;
    y_classf (Lz, Ly, Lx, ncls) or None; styles)."""
    pm = [(0, 1, 2, 3), (1, 0, 2, 3), (2, 0, 1, 3)]
    ipm = [(0, 1, 2), (1, 0, 2), (1, 2, 0)]
    cp = [(1, 2), (0, 2), (0, 1)]
    shape = imgs.shape[:-1]
    yf = np.zeros((*shape, 4), np.float32)
    y_classf = (np.zeros((*shape, n_cell_classes), np.float32)
                if n_cell_classes > 1 else None)
    styles = None
    for p in range(3):
        y, y_class, styles = run_net(
            net, imgs.transpose(pm[p]), n_cell_classes=n_cell_classes,
            batch_size=batch_size, augment=augment, bsize=bsize,
            tile_overlap=tile_overlap)
        yf[..., -1] += y[..., -1].transpose(ipm[p])
        for j in range(2):
            yf[..., cp[p][j]] += y[..., j].transpose(ipm[p])
        if y_classf is not None:
            for c in range(n_cell_classes):
                y_classf[..., c] += y_class[..., c].transpose(ipm[p])
    return yf, y_classf, styles


def _plane_value(plane: np.ndarray, dense_id: int) -> int:
    """Value in ``plane`` of the dense id ``pairwise_iou_matrix`` uses
    (sorted unique order)."""
    ids = np.unique(plane)
    ids = ids[ids > 0]
    return int(ids[dense_id - 1]) if dense_id - 1 < len(ids) else 0


def stitch3D(masks: np.ndarray, stitch_threshold: float = 0.25
             ) -> np.ndarray:
    """Stitch per-plane 2D instance masks into 3D instances by IoU
    linking (cellpose ``utils.stitch3D`` semantics)."""
    masks = np.asarray(masks).copy()
    mmax = int(masks[0].max())
    for i in range(len(masks) - 1):
        iou = pairwise_iou_matrix(masks[i], masks[i + 1])
        nxt = masks[i + 1]
        ids_next = np.unique(nxt)
        ids_next = ids_next[ids_next > 0]
        lookup = np.zeros(int(nxt.max()) + 1, masks.dtype)
        if iou.size == 0:
            # a plane without instances: the next plane's get fresh ids
            for gid in ids_next:
                mmax += 1
                lookup[gid] = mmax
            masks[i + 1] = lookup[nxt]
            continue
        iou = np.where(iou >= stitch_threshold, iou, 0.0)
        best = iou.argmax(axis=0)
        best_val = iou.max(axis=0)
        istitch = np.where(
            best_val > 0.0,
            np.array([_plane_value(masks[i], b + 1) for b in best]), 0)
        for idx in np.nonzero(best_val == 0.0)[0]:
            mmax += 1
            istitch[idx] = mmax
        for gid_local, gid in zip(ids_next, istitch):
            lookup[gid_local] = gid
        masks[i + 1] = lookup[nxt]
        mmax = max(mmax, int(masks[i + 1].max()))
    return masks


def _trilinear(fields: torch.Tensor, pz, py, px) -> torch.Tensor:
    """(3, Lz, Ly, Lx) sampled at float positions, corners clipped into the
    volume; the JAX package's term order (dz, then dy, then dx)."""
    _, Lz, Ly, Lx = fields.shape
    z0 = torch.clamp(torch.floor(pz), 0, Lz - 2)
    y0 = torch.clamp(torch.floor(py), 0, Ly - 2)
    x0 = torch.clamp(torch.floor(px), 0, Lx - 2)
    wz, wy, wx = pz - z0, py - y0, px - x0
    fl = fields.reshape(3, -1)
    base = ((z0.long() * Ly + y0.long()) * Lx + x0.long()).reshape(-1)
    out = 0.0
    for dz, wz_ in ((0, 1 - wz), (1, wz)):
        for dy, wy_ in ((0, 1 - wy), (1, wy)):
            for dx, wx_ in ((0, 1 - wx), (1, wx)):
                off = dz * Ly * Lx + dy * Lx + dx
                out = out + fl[:, base + off].reshape(fields.shape) * (
                    wz_ * wy_ * wx_)
    return out


def _follow_flows_3d(dP: torch.Tensor, iscell: torch.Tensor, niter: int
                     ) -> torch.Tensor:
    """Every voxel along dP/5: ceil(log2(niter)) squarings of the one-step
    map (2^k steps), positions clipped to the volume."""
    Lz, Ly, Lx = iscell.shape
    dev = dP.device
    u = dP * iscell[None].to(dP.dtype) / 5.0
    gz, gy, gx = torch.meshgrid(
        *(torch.arange(s, dtype=torch.float32, device=dev)
          for s in (Lz, Ly, Lx)), indexing="ij")

    def clamp(u):
        return torch.stack([torch.clamp(gz + u[0], 0.0, Lz - 1.0) - gz,
                            torch.clamp(gy + u[1], 0.0, Ly - 1.0) - gy,
                            torch.clamp(gx + u[2], 0.0, Lx - 1.0) - gx])

    u = clamp(u)
    for _ in range(max(1, int(np.ceil(np.log2(max(niter, 2)))))):
        u = clamp(u + _trilinear(u, gz + u[0], gy + u[1], gx + u[2]))
    return torch.stack([gz + u[0], gy + u[1], gx + u[2]])


def _get_masks_3d(p: torch.Tensor, iscell: torch.Tensor, n_expand: int = 5
                  ) -> torch.Tensor:
    """Landing histogram, seeds at 3×5×5 maxima with count > 10 (id = flat
    index + 1), basins over {count > 2} by 3×3×3 max propagation, then the
    label at each voxel's landing position."""
    Lz, Ly, Lx = iscell.shape
    fz = torch.clamp(torch.round(p[0]), 0, Lz - 1).long()
    fy = torch.clamp(torch.round(p[1]), 0, Ly - 1).long()
    fx = torch.clamp(torch.round(p[2]), 0, Lx - 1).long()
    flat = ((fz * Ly + fy) * Lx + fx).reshape(-1)
    h = torch.zeros(Lz * Ly * Lx, dtype=torch.float32, device=p.device)
    h.index_add_(0, flat, iscell.to(torch.float32).reshape(-1))
    h = h.reshape(Lz, Ly, Lx)
    hmax = F.max_pool3d(h[None, None], (3, 5, 5), 1, (1, 2, 2))[0, 0]
    seeds = (h >= hmax) & (h > 10)
    idx = torch.arange(1, Lz * Ly * Lx + 1, device=p.device,
                       dtype=torch.float64).reshape(Lz, Ly, Lx)
    seed_lab = torch.where(seeds, idx, 0.0)
    grow = h > 2
    lab = seed_lab
    for _ in range(n_expand):
        m = F.max_pool3d(lab[None, None], 3, 1, 1)[0, 0]
        lab = torch.where(grow & (lab == 0), m, lab)
        lab = torch.where(seeds, seed_lab, lab)
    masks = lab.reshape(-1)[flat].reshape(Lz, Ly, Lx).to(torch.int64)
    return torch.where(iscell, masks, 0)


def _relabel(raw: np.ndarray) -> np.ndarray:
    ids, remapped = np.unique(raw, return_inverse=True)
    masks = remapped.reshape(raw.shape).astype(np.int32)
    if ids[0] != 0:
        masks += 1
    return masks


def compute_masks_3d(dP: np.ndarray, cellprob: np.ndarray, niter: int = 200,
                     cellprob_threshold: float = 0.0,
                     flow_threshold: float = 0.4, min_size: int = 15,
                     device="cuda") -> np.ndarray:
    """3D instance recovery on ``device`` (flow QC is a 2D-only refinement,
    as in cellpose; ``flow_threshold`` is accepted and unused)."""
    cellprob = np.asarray(cellprob, np.float32)
    iscell_np = cellprob > cellprob_threshold
    if not iscell_np.any():
        return np.zeros(cellprob.shape, np.int32)
    dPt = torch.as_tensor(np.asarray(dP, np.float32), device=device)
    iscell = torch.as_tensor(iscell_np, device=device)
    p = _follow_flows_3d(dPt, iscell, niter)
    masks = _relabel(_get_masks_3d(p, iscell).cpu().numpy())
    if min_size > 0 and masks.max() > 0:
        counts = np.bincount(masks.ravel())
        small = counts < min_size
        small[0] = False
        masks[small[masks]] = 0
        masks = _relabel(masks)
    return masks
