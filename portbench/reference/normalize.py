"""Per-channel 1st–99th percentile normalization (cellpose's
``normalize99``), in float32: the exact percentiles of a sorted channel
with linear interpolation between ranks, for integer-valued images
(uint8 tiles) and float images alike. Written from the definition; the
port reads integer images' percentiles off a 256-bin histogram, which
gives the same values."""

from __future__ import annotations

import math

import torch


def _percentile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """Per-row percentile ``q`` of (C, N) by sorting (numpy's 'linear')."""
    s = torch.sort(flat, dim=1).values
    rank = q / 100.0 * (flat.shape[1] - 1)
    k = int(math.floor(rank))
    frac = rank - k
    hi = s[:, min(k + 1, flat.shape[1] - 1)]
    return s[:, k] + frac * (hi - s[:, k])


def normalize99(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) → float32 (H, W, C): ``(x − p1) / max(p99 − p1, 1e-3)``
    per channel."""
    x = img.to(torch.float32)
    flat = x.reshape(-1, x.shape[-1]).T.contiguous()
    lo = _percentile(flat, 1.0)
    hi = _percentile(flat, 99.0)
    return (x - lo) / torch.clamp(hi - lo, min=1e-3)
