"""Attention with the SAM decomposed relative-position bias (CUDA kernels +
plain PyTorch versions), differentiable.

Counterpart of ``classpose_tpu/nn/attention.py`` ``flash_attention_relpos_blc``
and its ``custom_vjp`` (``_attn_core``) in the production layout: qkv
(B, L, 3·n·hd) exactly as the qkv projection emits it, the bias projection
rel (B, L, n, H+W) with ``rel[..., :H]`` the row term and ``rel[..., H:]``
the column term. The forward kernel (``csrc/attention.cu``) and the
backward kernel (``csrc/attention_bwd.cu``) are bf16 only, as the TPU
kernels were.

:func:`attention_relpos` is differentiable through :class:`AttentionRelPos`:
for a CUDA tensor its forward is the forward kernel (which then also
writes the per-row log-sum-exp and an f32 copy of its output) and its
backward the backward kernel; for a CPU tensor the plain forward and
:func:`attention_relpos_bwd_plain`. Without a gradient to compute it
calls the forward alone and writes neither. A CUDA tensor launches the
kernels or raises.

:func:`flash_attention_relpos` is the counterpart of the head-major
``flash_attention_relpos`` (q, k, v (B, n, L, hd), rel_h (B, n, L, H),
rel_w (B, n, L, W)), the layout of the JAX Attention's fp32 branch; its
kernel (``csrc/attention_hm.cu``, kernel 8) takes fp32 and bf16 and, like
the TPU kernel, has no backward.
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


def attention_relpos_bwd_plain(qkv: torch.Tensor, rel: torch.Tensor,
                               dout: torch.Tensor, scale: float,
                               grid_hw: tuple[int, int], num_heads: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The vjp of :func:`attention_relpos_plain` in fp32 math (the
    counterpart of ``_attn_bwd_pallas``): dout (B, L, n·hd) → (dqkv in
    qkv's layout and dtype, drel in rel's layout and dtype)."""
    hd = _check(qkv, rel, grid_hw, num_heads)
    if dout.shape != (*qkv.shape[:2], num_heads * hd):
        raise ValueError(f"bad shape dout {tuple(dout.shape)}")
    with torch.enable_grad():
        a = qkv.detach().float().requires_grad_()
        r = rel.detach().float().requires_grad_()
        out = attention_relpos_plain(a, r, scale, grid_hw, num_heads)
        da, dr = torch.autograd.grad(out, (a, r), dout.float())
    return da.to(qkv.dtype), dr.to(rel.dtype)


def _check(qkv: torch.Tensor, rel: torch.Tensor, grid_hw, n: int) -> int:
    B, L, C3 = qkv.shape
    H, W = grid_hw
    hd = C3 // (3 * n)
    if C3 != 3 * n * hd or L != H * W or rel.shape != (B, L, n, H + W):
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)}, "
                         f"rel {tuple(rel.shape)}, grid {grid_hw}, n={n}")
    if rel.device != qkv.device or rel.dtype != qkv.dtype:
        raise ValueError("qkv and rel must share device and dtype")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {qkv.device}")
    return hd


# the kernels' tile loops: head width 64 and a rel row of at most 256
# columns (H + W): every square crop grid up to 128 x 128 (bsize 1024 at
# patch 8, the WSI CLI's tile); the C entry points repeat the limit
MAX_REL = 256


def _grid_supported(hd: int, H: int, W: int) -> bool:
    """Whether the attention kernels (1, 5 and 8) take a (H, W) token grid
    of head width ``hd``; which dtypes each takes is checked where it is
    launched (kernels 1 and 5 bf16, kernel 8 fp32 or bf16)."""
    return hd == 64 and H >= 1 and W >= 1 and H + W <= MAX_REL


def _check_kernel(qkv: torch.Tensor, rel: torch.Tensor, hd: int, L: int,
                  H: int, W: int) -> None:
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16, got {qkv.dtype}")
    if not _grid_supported(hd, H, W):
        raise ValueError(f"kernel needs hd=64 and H+W <= {MAX_REL}: "
                         f"hd={hd}, grid=({H}, {W})")
    if not (qkv.is_contiguous() and rel.is_contiguous()):
        raise ValueError("qkv and rel must be contiguous")
    if qkv.data_ptr() % 16 or rel.data_ptr() % 16:
        raise ValueError("kernel needs 16-byte aligned qkv and rel")


def _fwd_kernel(qkv: torch.Tensor, rel: torch.Tensor, scale: float,
                grid_hw: tuple[int, int], n: int, for_backward: bool):
    """Launch the forward kernel → (out, lse, out32): with
    ``for_backward`` also the per-row log-sum-exp (B, n, L) and the
    output before its bf16 rounding (B, L, n·hd), both f32, which the
    backward kernel takes; else those two are None."""
    B, L, C3 = qkv.shape
    H, W = grid_hw
    hd = C3 // (3 * n)
    _check_kernel(qkv, rel, hd, L, H, W)
    out = torch.empty((B, L, n * hd), dtype=qkv.dtype, device=qkv.device)
    lse = out32 = None
    if for_backward:
        lse = torch.empty((B, n, L), dtype=torch.float32, device=qkv.device)
        out32 = torch.empty((B, L, n * hd), dtype=torch.float32,
                            device=qkv.device)
    lib = _build.lib("attention")
    _build.check(
        lib.attn_fwd_bf16(
            qkv.data_ptr(), rel.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out32 is None else out32.data_ptr(), B, L, n, H, W,
            float(scale), _build.stream_ptr(qkv.device),
        ),
        "attn_fwd_bf16",
    )
    _build.count("attention_fwd")
    return out, lse, out32


def attention_relpos_bwd(qkv: torch.Tensor, rel: torch.Tensor,
                         out32: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, scale: float,
                         grid_hw: tuple[int, int], num_heads: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel: the forward's operands, its f32 output and
    log-sum-exp (:func:`_fwd_kernel` with ``for_backward``) plus the
    output cotangent → (dqkv, drel) in qkv's and rel's layouts. It takes
    every grid with H + W <= 256 (:func:`_grid_supported`), checked here;
    the TPU backward never checked its head-pair blocking (an odd head
    count left heads unwritten), the port's blocks are per head."""
    B, L, C3 = qkv.shape
    n = num_heads
    H, W = grid_hw
    hd = _check(qkv, rel, grid_hw, n)
    if qkv.device.type != "cuda":
        raise ValueError(f"the backward kernel runs on CUDA, not {qkv.device}")
    _check_kernel(qkv, rel, hd, L, H, W)
    if out32.shape != (B, L, n * hd) or dout.shape != out32.shape \
            or lse.shape != (B, n, L):
        raise ValueError(f"bad shapes out32 {tuple(out32.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if out32.dtype != torch.float32 or dout.dtype != qkv.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"dtypes out32 {out32.dtype}, dout {dout.dtype}, "
                        f"lse {lse.dtype}")
    if not all(t.is_contiguous() and t.device == qkv.device
               for t in (out32, dout, lse)):
        raise ValueError("out32, dout and lse must be contiguous on qkv's "
                         "device")
    dqkv = torch.empty_like(qkv)
    drel = torch.empty_like(rel)
    delta = torch.empty((B, n, L), dtype=torch.float32, device=qkv.device)
    lib = _build.lib("attention_bwd")
    _build.check(
        lib.attn_bwd_bf16(
            qkv.data_ptr(), rel.data_ptr(), out32.data_ptr(),
            dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
            drel.data_ptr(), B, L, n, H, W, float(scale),
            _build.stream_ptr(qkv.device),
        ),
        "attn_bwd_bf16",
    )
    _build.count("attention_bwd")
    return dqkv, drel


class AttentionRelPos(torch.autograd.Function):
    """Kernel forward and backward for CUDA tensors; with ``plain`` set
    (always for CPU tensors) the plain forward and
    :func:`attention_relpos_bwd_plain` instead, through the same saved
    tensors and layouts."""

    @staticmethod
    def forward(ctx, qkv, rel, scale, grid_hw, num_heads, plain):
        if plain:
            out = attention_relpos_plain(qkv, rel, scale, grid_hw, num_heads)
            lse = out32 = None
        else:
            out, lse, out32 = _fwd_kernel(qkv, rel, scale, grid_hw,
                                          num_heads, True)
        ctx.save_for_backward(qkv, rel, out32, lse)
        ctx.args = (scale, grid_hw, num_heads, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel, out32, lse = ctx.saved_tensors
        scale, grid_hw, n, plain = ctx.args
        if plain:
            dqkv, drel = attention_relpos_bwd_plain(qkv, rel, dout, scale,
                                                    grid_hw, n)
        else:
            dqkv, drel = attention_relpos_bwd(qkv, rel, out32, lse,
                                              dout.contiguous(), scale,
                                              grid_hw, n)
        return dqkv, drel, None, None, None, None


def attention_relpos(qkv: torch.Tensor, rel: torch.Tensor, scale: float,
                     grid_hw: tuple[int, int], num_heads: int
                     ) -> torch.Tensor:
    """softmax(q·kᵀ·scale + rel_h[i, j//W] + rel_w[i, j%W]) @ v per head.
    qkv (B, L, 3·n·hd), rel (B, L, n, H+W) → (B, L, n·hd)."""
    _check(qkv, rel, grid_hw, num_heads)
    plain = qkv.device.type == "cpu"
    if torch.is_grad_enabled() and (qkv.requires_grad or rel.requires_grad):
        return AttentionRelPos.apply(qkv, rel, scale, tuple(grid_hw),
                                     num_heads, plain)
    if plain:
        return attention_relpos_plain(qkv, rel, scale, grid_hw, num_heads)
    return _fwd_kernel(qkv, rel, scale, grid_hw, num_heads, False)[0]


def attention_relpos_plain_route(qkv: torch.Tensor, rel: torch.Tensor,
                                 scale: float, grid_hw: tuple[int, int],
                                 num_heads: int) -> torch.Tensor:
    """:func:`attention_relpos` with the plain versions on any device (the
    reference a run on the card is compared with)."""
    _check(qkv, rel, grid_hw, num_heads)
    if torch.is_grad_enabled() and (qkv.requires_grad or rel.requires_grad):
        return AttentionRelPos.apply(qkv, rel, scale, tuple(grid_hw),
                                     num_heads, True)
    return attention_relpos_plain(qkv, rel, scale, grid_hw, num_heads)


# ------------------------------------------------------- head-major (kernel 8)

def flash_attention_relpos_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, rel_h: torch.Tensor,
                                 rel_w: torch.Tensor, scale: float
                                 ) -> torch.Tensor:
    """``attention_reference``: fp32 logits and softmax, probabilities cast
    to v's dtype, fp32-accumulated AV product; (B, n, L, hd) in q's
    dtype."""
    B, n, L, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    bias = (rel_h.float()[..., :, None]
            + rel_w.float()[..., None, :]).reshape(B, n, L, L)
    p = torch.softmax(s + bias, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_hm(q, k, v, rel_h, rel_w, grid_hw) -> None:
    B, n, L, hd = q.shape
    H, W = grid_hw
    if k.shape != q.shape or v.shape != q.shape or L != H * W \
            or rel_h.shape != (B, n, L, H) or rel_w.shape != (B, n, L, W):
        raise ValueError(
            f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, rel_h {tuple(rel_h.shape)}, rel_w "
            f"{tuple(rel_w.shape)}, grid {grid_hw}")
    ts = (q, k, v, rel_h, rel_w)
    if any(t.device != q.device or t.dtype != q.dtype for t in ts):
        raise ValueError("q, k, v, rel_h and rel_w must share device and "
                         "dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


def _hm_kernel(q, k, v, rel_h, rel_w, scale: float, grid_hw) -> torch.Tensor:
    B, n, L, hd = q.shape
    H, W = grid_hw
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel takes fp32 or bf16, got {q.dtype}")
    fn = "attn_hm_f32" if q.dtype == torch.float32 else "attn_hm_bf16"
    if not _grid_supported(hd, H, W):
        raise ValueError(f"kernel needs hd=64 and H+W <= {MAX_REL} "
                         f"({q.dtype}): hd={hd}, grid={grid_hw}")
    if not all(t.is_contiguous() for t in (q, k, v, rel_h, rel_w)):
        raise ValueError("q, k, v, rel_h and rel_w must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, rel_h, rel_w)):
        raise ValueError("kernel needs 16-byte aligned q, k, v, rel_h and "
                         "rel_w")
    out = torch.empty_like(q)
    lib = _build.lib("attention_hm")
    _build.check(
        getattr(lib, fn)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
                         B, L, n, H, W, float(scale),
                         _build.stream_ptr(q.device)),
        fn,
    )
    _build.count("flash_attention_relpos")
    return out


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rel_h: torch.Tensor, rel_w: torch.Tensor,
                           scale: float, grid_hw: tuple[int, int] = (32, 32)
                           ) -> torch.Tensor:
    """softmax(q·kᵀ·scale + rel_h[i, j//W] + rel_w[i, j%W]) @ v per head.
    q/k/v (B, n, L, hd), rel_h (B, n, L, H), rel_w (B, n, L, W) with
    L = H·W → (B, n, L, hd) in q's dtype. On the card: fp32 or bf16,
    hd = 64, and no gradient (the kernel has no backward, as the TPU
    kernel had none)."""
    _check_hm(q, k, v, rel_h, rel_w, grid_hw)
    if q.device.type == "cpu":
        return flash_attention_relpos_plain(q, k, v, rel_h, rel_w, scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, rel_h, rel_w)):
        raise RuntimeError("flash_attention_relpos has no backward: its "
                           "kernel route takes no tensor that needs a "
                           "gradient")
    return _hm_kernel(q, k, v, rel_h, rel_w, scale, tuple(grid_hw))
