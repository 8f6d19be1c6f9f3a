"""Flow fields from instance masks: the flow-error QC's recomputation and
the training targets (counterpart of ``classpose_tpu/dynamics/flows.py``
``_diffuse_dyn`` / ``grad_from_T`` / ``masks_to_flows`` /
``labels_to_flows``).

Heat diffusion from each instance's centre (the in-mask pixel nearest its
centroid), restricted to same-instance 3×3 neighbours, then the
normalized central-difference gradient of log1p(T). The diffusion runs
through ``ops/diffusion.py``: a CUDA kernel for tensors on the card, its
plain version on the CPU. Geometries that pass the JAX package's
residency gate take ``masked_diffusion`` (kernel 4), all others
``diffuse_blocked`` (kernel 7) from zero with ``k = 1``; both give the
same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from classpose_tpu_torch.ops.diffusion import (
    diffuse_blocked,
    masked_diffusion,
    resident_diffusion_supported,
)


def _diffuse_dyn(masks: torch.Tensor, center_map: torch.Tensor, niter
                 ) -> torch.Tensor:
    """T after ``niter`` iterations; masks/center (H, W) or (B, H, W),
    niter an int or a (B,) int tensor (one count per tile)."""
    single = masks.ndim == 2
    ids = masks.to(torch.int32)
    cen = center_map.to(torch.float32)
    if single:
        ids, cen = ids[None], cen[None]
    B = ids.shape[0]
    if isinstance(niter, torch.Tensor):
        n = niter.to(device=ids.device, dtype=torch.int32).reshape(-1)
        n = n.expand(B) if n.numel() == 1 else n
    else:
        n = torch.full((B,), int(niter), dtype=torch.int32, device=ids.device)
    ids, cen, n = ids.contiguous(), cen.contiguous(), n.contiguous()
    if resident_diffusion_supported(*ids.shape[1:]):
        T = masked_diffusion(ids, cen, n)
    else:
        T = diffuse_blocked(torch.zeros_like(cen), ids, cen, n, k=1)
    return T[0] if single else T


def grad_from_T(masks: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Normalized log-gradient of T → unit flows (..., 2, H, W), zero off
    the instances."""
    H, W = masks.shape[-2:]
    fg = masks.to(torch.int32) > 0
    Tp = F.pad(torch.log1p(T), (1, 1, 1, 1))
    dy = (Tp[..., 2:2 + H, 1:1 + W] - Tp[..., 0:H, 1:1 + W]) / 2.0
    dx = (Tp[..., 1:1 + H, 2:2 + W] - Tp[..., 1:1 + H, 0:W]) / 2.0
    mag = torch.sqrt(dy ** 2 + dx ** 2)
    mu = torch.stack([dy, dx], dim=-3) / torch.clamp(mag, min=1e-20)[
        ..., None, :, :]
    return torch.where(fg[..., None, :, :], mu, 0.0).to(torch.float32)


def instance_center_map(masks: np.ndarray) -> np.ndarray:
    """(H, W) float32 map with a unit source at each instance's centre
    (the in-mask pixel nearest the instance centroid, lowest index on
    ties); host numpy, O(H·W) bincounts."""
    masks = np.asarray(masks)
    H, W = masks.shape
    ids = masks.ravel().astype(np.int64)
    fg = ids > 0
    out = np.zeros(H * W, np.float32)
    if not fg.any():
        return out.reshape(H, W)
    n = np.bincount(ids)
    yy, xx = np.divmod(np.arange(H * W, dtype=np.int64), W)
    sy = np.bincount(ids, weights=yy)
    sx = np.bincount(ids, weights=xx)
    cy = sy / np.maximum(n, 1)
    cx = sx / np.maximum(n, 1)
    d = (yy - cy[ids]) ** 2 + (xx - cx[ids]) ** 2
    d[~fg] = np.inf
    # per-instance argmin via a lexicographic sort on (id, distance, index)
    order = np.lexsort((np.arange(H * W), d, ids))
    sorted_ids = ids[order]
    first = np.ones(len(order), bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    out[order[first & (sorted_ids > 0)]] = 1.0
    return out.reshape(H, W)


def masks_to_flows(masks, niter: int = 200, device="cuda") -> torch.Tensor:
    """(H, W) instance labels → (2, H, W) unit flows [dy, dx] on
    ``device``; ``niter`` diffusion steps (≳ 2× the largest instance)."""
    m = torch.as_tensor(np.ascontiguousarray(masks, dtype=np.int32),
                        device=device)
    c = torch.as_tensor(instance_center_map(masks), device=device)
    return grad_from_T(m, _diffuse_dyn(m, c, int(niter)))


def _bucket(v: int, q: int) -> int:
    return int(q * np.ceil(max(v, 1) / q))


def _max_instance_extent(masks: np.ndarray) -> int:
    ext = 1
    for sl in ndimage.find_objects(masks):
        if sl is None:
            continue
        ext = max(ext, sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
    return int(ext)


def labels_to_flows(labels: np.ndarray, niter: int | None = None,
                    device="cuda") -> np.ndarray:
    """Instance label image → (4, H, W) float32 training target
    ``[instance, binary, flow_y, flow_x]``. Ids are densified first; the
    horizon is twice the largest instance's extent, clamped to
    [60, 1200] and rounded up to a multiple of 50, as the JAX package
    buckets it."""
    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(f"expected 2D instance labels, got {labels.shape}")
    ids, remapped = np.unique(labels, return_inverse=True)
    remapped = remapped.reshape(labels.shape).astype(np.int32)
    if ids[0] != 0:  # no background pixel present
        remapped += 1
    if remapped.max() == 0:
        z = np.zeros(labels.shape, np.float32)
        return np.stack([z, z, z, z])
    if niter is None:
        niter = 2 * _max_instance_extent(remapped)
    niter = _bucket(min(max(niter, 60), 1200), 50)
    mu = masks_to_flows(remapped, niter=niter, device=device).cpu().numpy()
    binary = (remapped > 0).astype(np.float32)
    return np.stack([remapped.astype(np.float32), binary, mu[0], mu[1]])
