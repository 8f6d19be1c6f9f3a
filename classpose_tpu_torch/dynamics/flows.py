"""Flow recomputation for the flow-error QC (counterpart of
``classpose_tpu/dynamics/flows.py`` ``_diffuse_dyn`` / ``grad_from_T``).

Heat diffusion from each instance's centre, restricted to same-instance
3×3 neighbours, then the normalized central-difference gradient of
log1p(T). The diffusion runs through ``ops/diffusion.py``: the CUDA
kernel for tensors on the card, the plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from classpose_tpu_torch.ops.diffusion import masked_diffusion


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
    T = masked_diffusion(ids.contiguous(), cen.contiguous(), n.contiguous())
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
