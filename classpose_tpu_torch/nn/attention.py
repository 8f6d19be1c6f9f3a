"""Attention with the SAM decomposed relative-position bias (CUDA kernel +
plain PyTorch version).

Counterpart of ``classpose_tpu/nn/attention.py`` ``flash_attention_relpos_blc``
in its production layout: qkv (B, L, 3·n·hd) exactly as the qkv projection
emits it, the bias projection rel (B, L, n, H+W) with ``rel[..., :H]`` the
row term and ``rel[..., H:]`` the column term. The kernel
(``csrc/attention.cu``) is bf16 only, as the TPU kernel was.

A wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from classpose_tpu_torch import _build


def attention_relpos_plain(qkv: torch.Tensor, rel: torch.Tensor,
                           scale: float, grid_hw: tuple[int, int],
                           num_heads: int) -> torch.Tensor:
    """``_attn_core_ref`` math: fp32 logits and softmax, probabilities
    cast to v's dtype, fp32-accumulated AV product. Returns (B, L, n·hd)
    in qkv's dtype."""
    B, L, C3 = qkv.shape
    n = num_heads
    hd = C3 // (3 * n)
    H, W = grid_hw

    def heads(i):
        return qkv[..., i * n * hd:(i + 1) * n * hd].reshape(
            B, L, n, hd).transpose(1, 2)

    q, k, v = heads(0), heads(1), heads(2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    rh = rel[..., :H].transpose(1, 2).float()   # (B, n, L, H)
    rw = rel[..., H:].transpose(1, 2).float()   # (B, n, L, W)
    bias = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
    p = torch.softmax(s + bias, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, L, n * hd)


def attention_relpos(qkv: torch.Tensor, rel: torch.Tensor, scale: float,
                     grid_hw: tuple[int, int], num_heads: int
                     ) -> torch.Tensor:
    """softmax(q·kᵀ·scale + rel_h[i, j//W] + rel_w[i, j%W]) @ v per head.
    qkv (B, L, 3·n·hd), rel (B, L, n, H+W) → (B, L, n·hd)."""
    B, L, C3 = qkv.shape
    n = num_heads
    H, W = grid_hw
    hd = C3 // (3 * n)
    if C3 != 3 * n * hd or L != H * W or rel.shape != (B, L, n, H + W):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)}, "
                         f"rel {tuple(rel.shape)}, grid {grid_hw}, n={n}")
    if rel.device != qkv.device or rel.dtype != qkv.dtype:
        raise ValueError("qkv and rel must share device and dtype")
    if qkv.device.type == "cpu":
        return attention_relpos_plain(qkv, rel, scale, grid_hw, n)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16, got {qkv.dtype}")
    if hd != 64 or L % 64 or H + W not in (16, 32, 64):
        raise ValueError(f"kernel needs hd=64, L%64==0, H+W in (16, 32, "
                         f"64): hd={hd}, L={L}, H+W={H + W}")
    if not (qkv.is_contiguous() and rel.is_contiguous()):
        raise ValueError("qkv and rel must be contiguous")
    out = torch.empty((B, L, n * hd), dtype=qkv.dtype, device=qkv.device)
    lib = _build.lib("attention")
    _build.check(
        lib.attn_fwd_bf16(
            qkv.data_ptr(), rel.data_ptr(), out.data_ptr(), B, L, n, H, W,
            float(scale), _build.stream_ptr(qkv.device),
        ),
        "attn_fwd_bf16",
    )
    _build.LAUNCHES["attention_fwd"] += 1
    return out
