"""Linear and convolution layers that keep fp32 parameters and cast them
to the input's dtype at use — the flax ``Dense``/``Conv`` convention of
the JAX package (fp32 params, bf16 compute in production)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, _cast(self.weight, x.dtype),
                        _cast(self.bias, x.dtype), self.stride,
                        self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, _cast(self.weight, x.dtype),
                                  _cast(self.bias, x.dtype), self.stride)
