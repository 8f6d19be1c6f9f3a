"""LayerNorm with fp32 statistics: the CUDA kernel (``csrc/layernorm.cu``)
and its plain PyTorch version (counterpart of
``classpose_tpu/nn/layernorm.py``: ``layernorm_pallas``,
``layernorm_ref``, ``FastLayerNorm`` and the neck's ``LayerNorm2d``).

The math: fp32 statistics, the fast variance ``max(0, E[x²] − E[x]²)`` for
the transformer blocks or the two-pass ``E[(x − μ)²]`` for the neck's
LayerNorm2d, fp32 affine, then a cast back to the input dtype.

The switch is the JAX package's: ``CLASSPOSE_LN_PALLAS=1`` (or ``on``)
takes the kernel for a CUDA tensor of a shape it supports
(:func:`layernorm_supported`); unset, ``off`` or ``interpret`` take the
plain version, which is also what a CPU tensor always gets. On the kernel
route the kernel runs or raises. It has no backward, as the TPU kernel
had none: it raises where autograd would need a gradient through it.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from classpose_tpu_torch import _build


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


def ln_kernel_on() -> bool:
    """``CLASSPOSE_LN_PALLAS`` is 1 or ``on`` (read at every call, as the
    JAX package reads it); unset, ``off`` and ``interpret`` are off."""
    return os.environ.get("CLASSPOSE_LN_PALLAS") in ("1", "on")


def layernorm_supported(x: torch.Tensor) -> bool:
    """The kernel's shapes: bf16, ``C % 128 == 0`` and ``C <= 2048``, any
    number of rows."""
    C = x.shape[-1]
    return x.dtype == torch.bfloat16 and C % 128 == 0 and C <= 2048


def layernorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-6,
                   fast_var: bool = True) -> torch.Tensor:
    """Launch the kernel on a contiguous bf16 CUDA ``x`` (…, C) with fp32
    ``weight``/``bias`` (C,) on the same card; returns a new bf16 tensor."""
    C = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError(f"the LayerNorm kernel runs on CUDA, not {x.device}")
    if not layernorm_supported(x):
        raise ValueError(f"LayerNorm kernel needs bf16 with C % 128 == 0 "
                         f"and C <= 2048, got {x.dtype} C={C}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (C,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be ({C},) contiguous float32 on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, weight, bias)):
        raise ValueError("x, weight and bias must be 16-byte aligned")
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return y
    _build.check(
        _build.lib("layernorm").layernorm_bf16(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, C, float(eps), int(fast_var), _build.stream_ptr(x.device),
        ),
        "layernorm_bf16",
    )
    _build.count("layernorm")
    return y


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6, fast_var: bool = True) -> torch.Tensor:
    """LayerNorm over the last axis: the kernel with the switch on for a
    supported CUDA tensor, else :func:`layernorm_ref`."""
    if not (ln_kernel_on() and x.device.type == "cuda"
            and layernorm_supported(x)):
        return layernorm_ref(x, weight, bias, eps, fast_var)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError(
            "the LayerNorm kernel has no backward (as the TPU kernel had "
            "none): unset CLASSPOSE_LN_PALLAS to train, or run under "
            "torch.no_grad()")
    return layernorm_cuda(x.contiguous(), weight, bias, eps, fast_var)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 params ``weight``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6, fast_var: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.fast_var = fast_var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps, self.fast_var)
