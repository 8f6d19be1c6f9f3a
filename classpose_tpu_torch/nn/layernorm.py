"""LayerNorm with fp32 statistics (counterpart of
``classpose_tpu/nn/layernorm.py`` ``layernorm_ref`` / ``FastLayerNorm``).

The JAX package's Pallas LayerNorm is off by default there, so the port
runs the same math as plain PyTorch: fp32 statistics, the fast variance
``max(0, E[x²] − E[x]²)`` for the transformer blocks or the two-pass
``E[(x − μ)²]`` for the neck's LayerNorm2d, fp32 affine, then a cast back
to the input dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def layernorm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-6, fast_var: bool = True) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    if fast_var:
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                          min=0.0)
    else:
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 params ``weight``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6, fast_var: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.fast_var = fast_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_ref(x, self.weight, self.bias, self.eps,
                             self.fast_var)
