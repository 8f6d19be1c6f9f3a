"""ClassTransformer: the ViT-L SAM image encoder with flow-field and class
heads, in PyTorch (counterpart of ``classpose_tpu/nn/vit_sam.py``).

- patch embed: conv ps×ps stride ps on a bsize² crop, plus an absolute
  positional embedding;
- ``depth`` pre-norm blocks of global attention with the SAM decomposed
  relative-position bias, built in the (B, L, n, H+W) layout the
  attention kernel takes (the JAX package's "cat" formulation); in
  training, a per-sample layer-drop ramping from 0 to ``rdrop`` over
  depth;
- neck: 1×1 conv → LayerNorm2d → 3×3 conv → LayerNorm2d;
- ``out`` head: 1×1 conv to nout·ps² channels and a pixel-shuffle readout;
- ``out_class`` head (n_cell_classes > 1): 1×1 conv or a UNet.

Tokens are NHWC, convolutions run NCHW. Precision follows the JAX
package: fp32 parameters cast to the compute dtype at use, fp32
LayerNorm statistics, exact-erf GELU on an fp32 upcast. In bf16 the
attention goes through the token-major CUDA kernels (``nn/attention.py``
``attention_relpos``, forward and backward). At fp32 without a gradient
(inference) it follows the JAX package's fp32 branch: head-major q, k, v,
``rel_h``/``rel_w`` from two einsums, then ``flash_attention_relpos``
(kernel 8 on the card, its plain version on the CPU). At fp32 with a
gradient it takes the plain version under autograd (``attention_relpos``
on the CPU, whose plain route has the kernels' autograd plumbing). The blocks' ``norm1``/``norm2`` and the neck's two LayerNorm2d
take the LayerNorm kernel (``nn/layernorm.py``) in bf16 on the card when
``CLASSPOSE_LN_PALLAS=1``, and its plain version otherwise.

Each block's sublayers run under spans (``net.norm1``, ``net.qkv``,
``net.relpos``, ``net.attention``, ``net.proj``, ``net.norm2``,
``net.fc1``, ``net.gelu``, ``net.fc2``; ``tracing.py``), which name the
kernels they launch in a profile and cost one flag read otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from classpose_tpu_torch.nn.attention import (
    attention_relpos,
    attention_relpos_plain,
    flash_attention_relpos,
)
from classpose_tpu_torch.nn.layernorm import LayerNorm
from classpose_tpu_torch.nn.layers import Conv2d, Linear
from classpose_tpu_torch.nn.unet import UNet
from classpose_tpu_torch.tracing import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# field of the JAX config that checkpoint metadata carries but the port
# has no use for (the TPU kernel switch), with the JAX default that the
# port's checkpoints carry, so that their metadata is the JAX package's
JAX_ONLY_FIELDS = {"use_pallas_attention": True}


@dataclasses.dataclass(frozen=True)
class ClassTransformerConfig:
    """Architecture hyperparameters (ViT-L SAM defaults used by cellpose);
    the JAX package's config without its TPU kernel switch (see
    ``JAX_ONLY_FIELDS``)."""

    backbone: str = "vit_l"
    ps: int = 8
    nout: int = 3
    bsize: int = 256
    rdrop: float = 0.4  # layer-drop rate of the last block in training
    n_cell_classes: int = 1
    feature_transformation_structure: Sequence[int] | None = None
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    neck_dim: int = 256
    dtype: str = "float32"  # compute dtype; params are always fp32

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def tokens_hw(self) -> int:
        return self.bsize // self.ps


def interp_rel_pos(rel_pos: torch.Tensor, max_rel_dist: int) -> torch.Tensor:
    """Linearly resize a decomposed rel-pos table to ``max_rel_dist`` rows
    (identity when it already has that many)."""
    n_old = rel_pos.shape[0]
    if n_old == max_rel_dist:
        return rel_pos
    dev = rel_pos.device
    x_old = torch.linspace(0.0, 1.0, n_old, device=dev)
    x_new = torch.linspace(0.0, 1.0, max_rel_dist, device=dev)
    idx = torch.searchsorted(x_old, x_new, right=True) - 1
    idx = torch.clamp(idx, 0, n_old - 2)
    t = (x_new - x_old[idx]) / (x_old[idx + 1] - x_old[idx])
    return rel_pos[idx] * (1 - t)[:, None] + rel_pos[idx + 1] * t[:, None]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """(q_size, k_size, head_dim) table with entry (i, j) =
    ``rel_pos[i - j + k_size - 1]`` after optional interpolation to
    2·max(q, k) − 1 rows (segment-anything ``get_rel_pos``)."""
    rel_pos = interp_rel_pos(rel_pos, 2 * max(q_size, k_size) - 1)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(
        q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64)]


class Attention(nn.Module):
    """Global multi-head attention with the SAM decomposed rel-pos bias
    (computed from unscaled q). (B, H, W, C) → (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, input_size: tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        L = H * W
        n = self.num_heads
        hd = C // n
        scale = hd ** -0.5
        with span("net.qkv"):
            qkv = self.qkv(x).reshape(B, L, 3 * C)
        if x.dtype == torch.float32 and not torch.is_grad_enabled():
            # the JAX fp32 branch: head-major q, k, v and two einsums
            with span("net.relpos"):
                Rh = get_rel_pos(H, H, self.rel_pos_h).to(x.dtype)
                Rw = get_rel_pos(W, W, self.rel_pos_w).to(x.dtype)
                q, k, v = qkv.reshape(B, L, 3, n, hd).permute(2, 0, 3, 1, 4)
                q_hw = q.reshape(B, n, H, W, hd)
                rel_h = torch.einsum("bnhwc,hkc->bnhwk", q_hw, Rh)
                rel_w = torch.einsum("bnhwc,wkc->bnhwk", q_hw, Rw)
            with span("net.attention"):
                out = flash_attention_relpos(
                    q.contiguous(), k.contiguous(), v.contiguous(),
                    rel_h.reshape(B, n, L, H).contiguous(),
                    rel_w.reshape(B, n, L, W).contiguous(), scale, (H, W))
            with span("net.proj"):
                return self.proj(out.transpose(1, 2).reshape(B, H, W, C))
        with span("net.relpos"):
            Rh = get_rel_pos(H, H, self.rel_pos_h).to(x.dtype)  # (H, H, hd)
            Rw = get_rel_pos(W, W, self.rel_pos_w).to(x.dtype)  # (W, W, hd)
            # per-token table [Rh[i // W] | Rw[i % W]]: (L, H+W, hd)
            T = torch.cat([Rh.repeat_interleave(W, dim=0),
                           Rw.repeat(H, 1, 1)], dim=1)
            q_tok = qkv[..., :C].reshape(B, L, n, hd)
            rel = torch.einsum("blnc,lkc->blnk", q_tok, T).contiguous()
        with span("net.attention"):
            if x.dtype == torch.bfloat16 or x.device.type == "cpu":
                out = attention_relpos(qkv.contiguous(), rel, scale, (H, W),
                                       n)
            else:
                out = attention_relpos_plain(qkv, rel, scale, (H, W), n)
        with span("net.proj"):
            return self.proj(out.reshape(B, H, W, C))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("net.fc1"):
            y = self.lin1(x)
        with span("net.gelu"):
            yf = y.float()
            y = (0.5 * yf * (1.0 + torch.erf(yf * 0.7071067811865476))).to(
                x.dtype)
        with span("net.fc2"):
            return self.lin2(y)


class Block(nn.Module):
    """Pre-norm transformer block (SAM image-encoder style, windowless)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 input_size: tuple[int, int]):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, input_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("net.norm1"):
            h = self.norm1(x)
        x = x + self.attn(h)
        with span("net.norm2"):
            h = self.norm2(x)
        return x + self.mlp(h)


def pixel_shuffle(x: torch.Tensor, ps: int, n_channels: int) -> torch.Tensor:
    """Depth-to-space readout: (B, H, W, C·ps²) NHWC → (B, H·ps, W·ps, C),
    input channel c·ps² + dy·ps + dx going to channel c at (dy, dx)."""
    B, H, W, _ = x.shape
    x = x.reshape(B, H, W, n_channels, ps, ps).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * ps, W * ps, n_channels)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def draw_drop_mask(cfg: ClassTransformerConfig, n: int,
                   generator: torch.Generator) -> torch.Tensor:
    """A (n, depth) layer-drop mask (True = drop) from ``generator``, on
    its device: block i is dropped with probability
    ``linspace(0, rdrop, depth)[i]``. A data-parallel step draws it for
    the global batch and gives each rank its rows."""
    gdev = generator.device
    p = torch.linspace(0.0, cfg.rdrop, cfg.depth, device=gdev)
    return torch.rand((n, cfg.depth), generator=generator, device=gdev) < p


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: ClassTransformerConfig):
        super().__init__()
        self.cfg = cfg
        thw = cfg.tokens_hw
        E, D = cfg.embed_dim, cfg.neck_dim
        self.patch_embed = Conv2d(3, E, cfg.ps, stride=cfg.ps)
        self.pos_embed = nn.Parameter(torch.zeros(1, thw, thw, E))
        self.blocks = nn.ModuleList(
            Block(E, cfg.num_heads, cfg.mlp_ratio, (thw, thw))
            for _ in range(cfg.depth)
        )
        self.neck_conv1 = Conv2d(E, D, 1, bias=False)
        self.neck_ln1 = LayerNorm(D, fast_var=False)
        self.neck_conv2 = Conv2d(D, D, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm(D, fast_var=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                drop_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 3, h, w) NCHW → (B, thw, thw, neck_dim) NHWC.

        With ``train`` and ``rdrop > 0``, block i is dropped per sample
        with probability ``linspace(0, rdrop, depth)[i]``: a (B, depth)
        ``drop_mask`` (True = drop) or one drawn from ``generator``; with
        neither, every block runs (as the JAX package without a key)."""
        x = _nhwc(self.patch_embed(x))
        x = x + self.pos_embed.to(x.dtype)
        cfg = self.cfg
        if train and cfg.rdrop > 0 and (drop_mask is not None
                                        or generator is not None):
            if drop_mask is None:
                drop_mask = draw_drop_mask(cfg, x.shape[0], generator)
            drop = drop_mask.to(device=x.device, dtype=x.dtype)
            for i, blk in enumerate(self.blocks):
                m = drop[:, i][:, None, None, None]
                x = x * m + blk(x) * (1 - m)
        else:
            for blk in self.blocks:
                x = blk(x)
        x = self.neck_ln1(_nhwc(self.neck_conv1(_nchw(x))))
        return self.neck_ln2(_nhwc(self.neck_conv2(_nchw(x))))


class ClassTransformer(nn.Module):
    """Input (B, 3, H, W); returns ``(out, style)`` with out (B,
    n_cell_classes+3, H, W) when n_cell_classes > 1 (class logits first,
    then [flowY, flowX, cellprob]) else (B, 3, H, W), in the compute
    dtype, and style (B, 256) fp32 zeros."""

    def __init__(self, cfg: ClassTransformerConfig):
        super().__init__()
        self.cfg = cfg
        D, ps = cfg.neck_dim, cfg.ps
        self.encoder = ImageEncoderViT(cfg)
        self.out = Conv2d(D, cfg.nout * ps * ps, 1)
        if cfg.n_cell_classes > 1:
            nc = cfg.n_cell_classes * ps * ps
            if cfg.feature_transformation_structure is not None:
                self.out_class = UNet(
                    D, nc, tuple(cfg.feature_transformation_structure))
            else:
                self.out_class = Conv2d(D, nc, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                drop_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """``train``/``drop_mask``/``generator``: the layer-drop of
        :meth:`ImageEncoderViT.forward`."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        if dt == torch.float32:
            # fp32 contract: true fp32 products, no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        feats = _nchw(self.encoder(x.to(dt), train, drop_mask, generator))
        seg = pixel_shuffle(_nhwc(self.out(feats)), cfg.ps, cfg.nout)
        if cfg.n_cell_classes > 1:
            cls = pixel_shuffle(_nhwc(self.out_class(feats)), cfg.ps,
                                cfg.n_cell_classes)
            out = torch.cat([cls, seg], dim=-1)
        else:
            out = seg
        style = torch.zeros((x.shape[0], 256), dtype=torch.float32,
                            device=x.device)
        return _nchw(out), style
