"""Image resize with ``jax.image.resize`` semantics (the JAX package resizes
images, flows and label maps with it).

- ``"linear"``: half-pixel centres (input coordinate ``(i + 0.5)/s − 0.5``
  for output index i at scale s = out/in) and a triangle kernel. When
  downsampling the kernel is widened by 1/s and the weights of each output
  sample are normalized to sum to 1 (antialiasing); samples outside
  ``[−0.5, in − 0.5]`` get no weight. ``F.interpolate`` matches neither the
  antialiased downsample nor the weight normalization, so the weights are
  computed here in float32 as JAX computes them (``compute_weight_mat``),
  and each resized axis is a weighted sum over a band of input indices.
- ``"nearest"``: input index ``floor((i + 0.5)·in/out)``, in integers
  (``((2i + 1)·in) // (2·out)``); any dtype, integer label maps included.
  JAX computes it in float32, and where ``(i + 0.5)·in/out`` is an exact
  integer its division on the CPU rounds either way from size to size;
  everywhere else the two agree.

Every axis whose size changes is resized; the others are left alone.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(..., "linear")``
    along one axis (antialiased)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    valid = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(valid[None, :], w, f32(0.0)).astype(f32)


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Input index of each output sample of the ``"nearest"`` resize."""
    return (2 * np.arange(n_out, dtype=np.int64) + 1) * n_in // (2 * n_out)


def _linear_axis(x: torch.Tensor, d: int, n_out: int) -> torch.Tensor:
    """Resize axis ``d`` as a banded weighted sum: output j takes
    Σ_k w[idx[j, k], j]·x[idx[j, k]] over the nonzero weights."""
    n_in = x.shape[d]
    w = linear_weights(n_in, n_out)
    nz = w != 0
    width = max(int(nz.sum(axis=0).max()), 1)
    first = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    idx = np.clip(first[:, None] + np.arange(width)[None, :], 0, n_in - 1)
    wk = np.take_along_axis(w, idx.T, axis=0).T  # (n_out, width)
    wk = np.where(first[:, None] + np.arange(width)[None, :] < n_in, wk, 0)
    xd = x.movedim(d, -1)
    idx_t = torch.from_numpy(idx).to(x.device)
    wk_t = torch.from_numpy(wk.astype(np.float32)).to(x.device)
    out = torch.zeros((*xd.shape[:-1], n_out), dtype=torch.float32,
                      device=x.device)
    for k in range(width):
        out = out + xd[..., idx_t[:, k]] * wk_t[:, k]
    return out.movedim(-1, d)


def resize(x: torch.Tensor, shape, method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``method`` in
    ``"linear"`` (float32 out) and ``"nearest"`` (x's dtype)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} for a {x.ndim}-D tensor")
    if method not in ("linear", "nearest"):
        raise ValueError(f"method {method!r}")
    if method == "linear":
        x = x.to(torch.float32)
    for d, n_out in enumerate(shape):
        if x.shape[d] == n_out:
            continue
        if method == "nearest":
            idx = torch.from_numpy(nearest_index(x.shape[d], n_out)).to(
                x.device)
            x = x.index_select(d, idx)
        else:
            x = _linear_axis(x, d, n_out)
    return x
