"""The ClassTransformer forward in plain PyTorch at float32, on a state
dict with the port's key names (``harness/weights.py`` makes it).

Written from the architecture (the Cellpose-SAM ViT-L image encoder with
decomposed rel-pos attention, the neck, the 1×1 flow and class heads and
their pixel-shuffle readout), not from the port's module; it follows
``classpose_tpu_torch/nn/torch_replica.py`` in its equations. Departures
from the port that do not change the function: the blocks' LayerNorm
takes the two-pass variance, the attention is an explicit softmax.

``mode`` sets the arithmetic: ``fp32`` with TF32 off, the reference;
``tf32``, every matrix product (linear layers, convolutions, the rel-pos
products and both attention products) with TF32 on; ``fp8``, the path a
float8 GEMM port of the bf16 configuration would take: every matrix
product's operands rounded to float8 e4m3 with one scale per tensor
(amax / 448), products accumulated in float32, and every tensor kept
between products (the residual stream, the outputs of the products, the
LayerNorms, GELU and the heads) in bfloat16, as the program keeps them;
LayerNorm statistics and the softmax in float32. The last two are the
controls of the fp32 and bf16 configurations.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def arithmetic(mode: str):
    """TF32 on only for ``tf32``; the previous switches restored after."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _q(t: torch.Tensor, mode: str) -> torch.Tensor:
    """A matrix product's operand as ``mode`` rounds it (float32 out)."""
    if mode != "fp8":
        return t
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _k(t: torch.Tensor, mode: str) -> torch.Tensor:
    """A tensor kept between products as ``mode`` keeps it (float32
    out)."""
    if mode != "fp8":
        return t
    return t.to(torch.bfloat16).to(torch.float32)


def _linear(x, w, b, mode):
    return _k(F.linear(_q(x, mode), _q(w, mode), b), mode)


def _conv(x, w, b, mode, **kw):
    return _k(F.conv2d(_q(x, mode), _q(w, mode), b, **kw), mode)


def _layernorm(x, w, b, mode, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return _k((x - mu) * torch.rsqrt(var + eps) * w + b, mode)


def _rel_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, hd): entry (i, j) = rel_pos[i − j + size − 1]."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError("rel-pos table of another length")
    i = torch.arange(size, device=rel_pos.device)
    return rel_pos[i[:, None] - i[None, :] + size - 1]


def _attention(x, sd, p, n_heads, mode):
    B, H, W, E = x.shape
    L, hd = H * W, E // n_heads
    qkv = _linear(x.reshape(B, L, E), sd[p + "qkv.weight"],
                  sd[p + "qkv.bias"], mode)
    q, k, v = qkv.reshape(B, L, 3, n_heads, hd).permute(2, 0, 3, 1, 4)
    qq = _q(q, mode).reshape(B, n_heads, H, W, hd)
    rh = _k(torch.einsum("bnhwc,hkc->bnhwk", qq,
                         _q(_rel_table(sd[p + "rel_pos_h"], H), mode)), mode)
    rw = _k(torch.einsum("bnhwc,wkc->bnhwk", qq,
                         _q(_rel_table(sd[p + "rel_pos_w"], W), mode)), mode)
    logits = torch.matmul(_q(q * hd ** -0.5, mode),
                          _q(k, mode).transpose(-1, -2))
    logits = (logits.reshape(B, n_heads, H, W, H, W)
              + rh[..., :, None] + rw[..., None, :]).reshape(
                  B, n_heads, L, L)
    prob = torch.softmax(logits, dim=-1)
    out = _k(torch.matmul(_q(prob, mode), _q(v, mode)), mode)
    out = out.transpose(1, 2).reshape(B, H, W, E)
    return _linear(out, sd[p + "proj.weight"], sd[p + "proj.bias"], mode)


def _mlp(x, sd, p, mode):
    y = _linear(x, sd[p + "lin1.weight"], sd[p + "lin1.bias"], mode)
    y = _k(0.5 * y * (1.0 + torch.erf(y * 0.7071067811865476)), mode)
    return _linear(y, sd[p + "lin2.weight"], sd[p + "lin2.bias"], mode)


def _layernorm2d(x, w, b, mode, eps=1e-6):
    return _layernorm(x.permute(0, 2, 3, 1), w, b, mode, eps).permute(
        0, 3, 1, 2)


def _pixel_shuffle(x: torch.Tensor, ps: int, c: int) -> torch.Tensor:
    """(B, c·ps², h, w) → (B, c, h·ps, w·ps): channel c·ps² + dy·ps + dx
    goes to channel c at (dy, dx)."""
    B, _, h, w = x.shape
    x = x.reshape(B, c, ps, ps, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, c, h * ps, w * ps)


def forward(sd: dict, m: dict, x: torch.Tensor, mode: str = "fp32"
            ) -> torch.Tensor:
    """(B, 3, bsize, bsize) float32 crops → (B, n_cell_classes + 3, bsize,
    bsize) float32: class logits (when n_cell_classes > 1), then [flowY,
    flowX, cellprob]."""
    ps, nh = m["ps"], m["num_heads"]
    ncls = m["n_cell_classes"]
    with torch.no_grad(), arithmetic(mode):
        h = _conv(x.float(), sd["encoder.patch_embed.weight"],
                  sd["encoder.patch_embed.bias"], mode, stride=ps)
        h = _k(h.permute(0, 2, 3, 1) + sd["encoder.pos_embed"], mode)
        for i in range(m["depth"]):
            p = f"encoder.blocks.{i}."
            h = _k(h + _attention(_layernorm(h, sd[p + "norm1.weight"],
                                             sd[p + "norm1.bias"], mode),
                                  sd, p + "attn.", nh, mode), mode)
            h = _k(h + _mlp(_layernorm(h, sd[p + "norm2.weight"],
                                       sd[p + "norm2.bias"], mode),
                            sd, p + "mlp.", mode), mode)
        f = h.permute(0, 3, 1, 2)
        f = _layernorm2d(_conv(f, sd["encoder.neck_conv1.weight"], None,
                               mode),
                         sd["encoder.neck_ln1.weight"],
                         sd["encoder.neck_ln1.bias"], mode)
        f = _layernorm2d(_conv(f, sd["encoder.neck_conv2.weight"], None,
                               mode, padding=1),
                         sd["encoder.neck_ln2.weight"],
                         sd["encoder.neck_ln2.bias"], mode)
        seg = _pixel_shuffle(_conv(f, sd["out.weight"], sd["out.bias"],
                                   mode), ps, m["nout"])
        if ncls <= 1:
            return seg
        cls = _pixel_shuffle(_conv(f, sd["out_class.weight"],
                                   sd["out_class.bias"], mode), ps, ncls)
        return torch.cat([cls, seg], dim=1)


def forward_blocks(sd: dict, m: dict, crops: torch.Tensor, mode: str,
                   block: int) -> torch.Tensor:
    """:func:`forward` over ``crops`` in blocks of ``block`` crops."""
    return torch.cat([forward(sd, m, crops[i:i + block], mode)
                      for i in range(0, crops.shape[0], block)])
