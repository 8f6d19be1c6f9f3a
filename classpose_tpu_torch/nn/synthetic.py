"""Structured synthetic checkpoints for the port (counterpart of
``classpose_tpu/nn/synthetic.py``, emitting the port's ``state_dict``).

Weights crafted so the unmodified ClassTransformer emits a designed flow
field for any input: patch embed and every block are zero, so the token
stream is exactly ``pos_embed``; ``pos_embed`` holds a standardized
encoding of the per-token output values with exact zero mean and equal
variance over the neck channels, so both neck LayerNorm2ds reduce to one
token-independent scale; fixed identity convs decode the values. The
field is a period-``period`` grid of radius-``radius`` cells with
cellpose-style 5·unit flows toward each centre and ±6 cellprob — about
one cell per 32² pixels, ~1k per 1024² tile at the defaults.
"""

from __future__ import annotations

import numpy as np
import torch

PERIOD = 32
RADIUS = 13.0


def design_field(bsize: int = 256, period: int = PERIOD,
                 radius: float = RADIUS) -> np.ndarray:
    """(3, bsize, bsize) float32: [flowY, flowX, cellprob]."""
    yy, xx = np.mgrid[0:bsize, 0:bsize].astype(np.float32)
    cy = (np.floor(yy / period) + 0.5) * period
    cx = (np.floor(xx / period) + 0.5) * period
    dy = cy - yy
    dx = cx - xx
    r = np.sqrt(dy * dy + dx * dx)
    inside = r <= radius
    rs = np.maximum(r, 1e-6)
    fy = np.where(inside & (r > 0.5), 5.0 * dy / rs, 0.0)
    fx = np.where(inside & (r > 0.5), 5.0 * dx / rs, 0.0)
    prob = np.where(inside, 6.0, -6.0)
    return np.stack([fy, fx, prob]).astype(np.float32)


def structured_params(cfg, period: int = PERIOD, radius: float = RADIUS,
                      dominant_class: int = 1) -> dict[str, torch.Tensor]:
    """``state_dict`` for ``ClassTransformer(cfg)`` whose seg channels are
    ``design_field(cfg.bsize, period, radius)`` (to ~1e-2) and whose class
    logits are constant with ``dominant_class`` on top, for any input.
    Needs ``nout·ps² + 4 <= neck_dim <= embed_dim``."""
    from classpose_tpu_torch.nn.vit_sam import ClassTransformer

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ClassTransformer(cfg)
                  .state_dict().items()}
    sd = {k: torch.zeros(s, dtype=torch.float32) for k, s in shapes.items()}

    thw, ps, nout = cfg.tokens_hw, cfg.ps, cfg.nout
    F = design_field(cfg.bsize, period, radius)
    g = np.zeros((thw, thw, nout * ps * ps), np.float32)
    for c in range(nout):
        blk = F[c].reshape(thw, ps, thw, ps).transpose(0, 2, 1, 3)
        g[..., c * ps * ps:(c + 1) * ps * ps] = blk.reshape(thw, thw, ps * ps)

    D = cfg.neck_dim
    ng = g.shape[-1]
    n_top = D - ng - 2
    n_top -= n_top % 2
    if n_top < 2:
        raise ValueError(f"neck_dim={D} too small for ng={ng} (need >= ng+4)")
    if D > cfg.embed_dim:
        raise ValueError("neck_dim must be <= embed_dim")
    emb = np.zeros((thw, thw, D), np.float32)
    emb[..., :ng] = g
    s = g.sum(-1)
    q = (g * g).sum(-1)
    emb[..., ng + n_top] = -s / 2.0
    emb[..., ng + n_top + 1] = -s / 2.0
    base = q + (s * s) / 2.0
    C = float(1.25 * base.max() / D)
    need = C * D - base
    if np.any(need <= 0):
        raise ValueError("variance top-up went negative")
    a = np.sqrt(need / n_top)
    alt = np.tile([1.0, -1.0], n_top // 2).astype(np.float32)
    emb[..., ng:ng + n_top] = a[..., None] * alt
    emb /= np.sqrt(C)
    sd["encoder.pos_embed"][0, :, :, :D] = torch.from_numpy(emb)

    for k, v in sd.items():  # LayerNorm scales to 1
        if k.endswith(".weight") and v.ndim == 1:
            v.fill_(1.0)

    w1 = sd["encoder.neck_conv1.weight"]  # (D, E, 1, 1)
    w2 = sd["encoder.neck_conv2.weight"]  # (D, D, 3, 3)
    for i in range(D):
        w1[i, i, 0, 0] = 1.0
        w2[i, i, 1, 1] = 1.0
    wo = sd["out.weight"]  # (ng, D, 1, 1)
    for i in range(ng):
        wo[i, i, 0, 0] = float(np.float32(np.sqrt(C)))

    if cfg.n_cell_classes > 1:
        bo = sd["out_class.bias"]
        bo.zero_()
        bo[dominant_class * ps * ps:(dominant_class + 1) * ps * ps] = 5.0
    return sd


def perturbed_structured_params(cfg, ripple: float = 0.5, seed: int = 0,
                                attn_ripple: float = 0.0,
                                **kw) -> dict[str, torch.Tensor]:
    """Structured weights whose output depends on the input (counterpart
    of the JAX package's ``perturbed_structured_params``, the same numbers
    for the same seed): a random patch embed perturbs the token stream, so
    the decoded field is the designed one plus an input-driven ripple of
    std ≈ ``ripple`` decoded-field units (flows are ±5, cellprob ±6). The
    kernel's std is ``ripple / (√C · √(fan_in/3))``, with √C the ``out``
    kernel's diagonal and ``fan_in = 3·ps²`` taps of percentile-normalized
    input (E[x²] ≈ 1/3).

    With ``attn_ripple > 0`` (drawn after the patch embed, so the rest is
    unchanged) every block's attention is live too: ``qkv`` weights of
    std 1/√E make q, k and v of unit scale from the unit-variance
    ``norm1`` output, and ``proj`` weights of std ``attn_ripple /
    (√C·√depth·√E)`` add at most ``attn_ripple`` decoded-field units over
    all blocks (each block's attention output has rms ≤ 1). The blocks'
    LayerNorms and attention then reach the masks."""
    sd = structured_params(cfg, **kw)
    rng = np.random.default_rng(seed)
    sqrt_c = float(sd["out.weight"][0, 0, 0, 0])
    ps, E = cfg.ps, cfg.embed_dim
    a = ripple / (sqrt_c * np.sqrt(3 * ps * ps / 3.0))
    k = (rng.normal(size=(ps, ps, 3, E)) * a).astype(np.float32)  # HWIO
    sd["encoder.patch_embed.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    sd["encoder.patch_embed.bias"] = torch.zeros(E)
    if attn_ripple > 0:
        s = attn_ripple / (sqrt_c * np.sqrt(cfg.depth) * np.sqrt(E))
        for i in range(cfg.depth):
            pre = f"encoder.blocks.{i}.attn."
            sd[pre + "qkv.weight"] = torch.from_numpy(
                (rng.normal(size=(3 * E, E)) / np.sqrt(E)).astype(np.float32))
            sd[pre + "proj.weight"] = torch.from_numpy(
                (rng.normal(size=(E, E)) * s).astype(np.float32))
    return sd
