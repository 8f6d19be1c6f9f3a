"""Structured synthetic ViT-L weights, made on the device from a seed.

Frozen copy of ``classpose_tpu_torch/nn/synthetic.py``
(``design_field``, ``structured_params``, ``perturbed_structured_params``)
and of the live checkpoint ``chip_smoke.py`` builds from it, rewritten in
torch so that every tensor is made on the device, the large ones in a few
calls of one ``torch.Generator``. The benchmark hands the same state dict
to the program and, made again from the same seed, to the reference.

The design: the patch embed's and every block's contributions are small
ripples on top of ``pos_embed``, which holds a standardized encoding of a
period-``period`` grid of radius-``radius`` cells (flows of 5 toward each
centre, cellprob ±6), so that the dynamics find ~1k cells in a 1024² tile
whatever the input. Unlike ``structured_params``, every block is live:
``qkv`` of std 1/√E, the rel-pos tables of std ``relpos_std``, ``proj``
of std ``attn_ripple / (√C·√depth·√E)``, ``lin1`` of std 1/√E and
``lin2`` of std ``mlp_ripple / (√C·√depth·√(4E))``, so every GEMM and
attention call reaches the masks; the class head is random with std
``class_std / √D`` on top of a bias of ``class_bias`` for class
``dominant_class`` (``structured_params``' design), so the class logits
follow the input while every instance's vote stays clear.
Keys and shapes are the port's ``ClassTransformer.state_dict()``.
"""

from __future__ import annotations

import math

import torch


def design_field(bsize: int, period: int, radius: float,
                 device) -> torch.Tensor:
    """(3, bsize, bsize) float32: [flowY, flowX, cellprob]."""
    r_ = torch.arange(bsize, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(r_, r_, indexing="ij")
    cy = (torch.floor(yy / period) + 0.5) * period
    cx = (torch.floor(xx / period) + 0.5) * period
    dy, dx = cy - yy, cx - xx
    r = torch.sqrt(dy * dy + dx * dx)
    inside = r <= radius
    rs = torch.clamp(r, min=1e-6)
    live = inside & (r > 0.5)
    fy = torch.where(live, 5.0 * dy / rs, 0.0)
    fx = torch.where(live, 5.0 * dx / rs, 0.0)
    prob = torch.where(inside, 6.0, -6.0)
    return torch.stack([fy, fx, prob])


def shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Key → shape of the port's ``ClassTransformer`` state dict for the
    model block ``m`` of a configuration file (1×1 class head)."""
    E, D, ps = m["embed_dim"], m["neck_dim"], m["ps"]
    thw = m["bsize"] // ps
    hd = E // m["num_heads"]
    H = int(E * m["mlp_ratio"])
    out = {
        "encoder.pos_embed": (1, thw, thw, E),
        "encoder.patch_embed.weight": (E, 3, ps, ps),
        "encoder.patch_embed.bias": (E,),
    }
    for i in range(m["depth"]):
        p = f"encoder.blocks.{i}."
        out.update({
            p + "norm1.weight": (E,), p + "norm1.bias": (E,),
            p + "attn.rel_pos_h": (2 * thw - 1, hd),
            p + "attn.rel_pos_w": (2 * thw - 1, hd),
            p + "attn.qkv.weight": (3 * E, E), p + "attn.qkv.bias": (3 * E,),
            p + "attn.proj.weight": (E, E), p + "attn.proj.bias": (E,),
            p + "norm2.weight": (E,), p + "norm2.bias": (E,),
            p + "mlp.lin1.weight": (H, E), p + "mlp.lin1.bias": (H,),
            p + "mlp.lin2.weight": (E, H), p + "mlp.lin2.bias": (E,),
        })
    out.update({
        "encoder.neck_conv1.weight": (D, E, 1, 1),
        "encoder.neck_ln1.weight": (D,), "encoder.neck_ln1.bias": (D,),
        "encoder.neck_conv2.weight": (D, D, 3, 3),
        "encoder.neck_ln2.weight": (D,), "encoder.neck_ln2.bias": (D,),
        "out.weight": (m["nout"] * ps * ps, D, 1, 1),
        "out.bias": (m["nout"] * ps * ps,),
    })
    if m["n_cell_classes"] > 1:
        nc = m["n_cell_classes"] * ps * ps
        out["out_class.weight"] = (nc, D, 1, 1)
        out["out_class.bias"] = (nc,)
    return out


def make_weights(m: dict, w: dict, seed: int, device) -> dict:
    """The state dict for model block ``m`` and weight block ``w`` of a
    configuration file, float32 on ``device``, from ``seed``."""
    dev = torch.device(device)
    E, D, ps, nout = m["embed_dim"], m["neck_dim"], m["ps"], m["nout"]
    depth, thw = m["depth"], m["bsize"] // ps
    hd = E // m["num_heads"]
    H = int(E * m["mlp_ratio"])
    sd = {k: torch.zeros(s, dtype=torch.float32, device=dev)
          for k, s in shapes(m).items()}

    # pos_embed: the design field, standardized (structured_params)
    F = design_field(m["bsize"], w["period"], w["radius"], dev)
    g = F.reshape(nout, thw, ps, thw, ps).permute(1, 3, 0, 2, 4).reshape(
        thw, thw, nout * ps * ps)
    ng = g.shape[-1]
    n_top = D - ng - 2
    n_top -= n_top % 2
    if n_top < 2 or D > E:
        raise ValueError(f"neck_dim {D} cannot hold {ng} decoded channels")
    s = g.sum(-1)
    q = (g * g).sum(-1)
    base = q + s * s / 2.0
    C = float(1.25 * float(base.max()) / D)
    need = C * D - base
    if bool((need <= 0).any()):
        raise ValueError("variance top-up went negative")
    a = torch.sqrt(need / n_top)
    alt = torch.tensor([1.0, -1.0], device=dev).repeat(n_top // 2)
    emb = torch.zeros((thw, thw, D), device=dev)
    emb[..., :ng] = g
    emb[..., ng:ng + n_top] = a[..., None] * alt
    emb[..., ng + n_top] = -s / 2.0
    emb[..., ng + n_top + 1] = -s / 2.0
    sd["encoder.pos_embed"][0, :, :, :D] = emb / math.sqrt(C)
    for k, v in sd.items():  # LayerNorm scales to 1
        if k.endswith(".weight") and v.ndim == 1:
            v.fill_(1.0)
    eye = torch.arange(D, device=dev)
    sd["encoder.neck_conv1.weight"][eye, eye, 0, 0] = 1.0
    sd["encoder.neck_conv2.weight"][eye, eye, 1, 1] = 1.0
    sqrt_c = math.sqrt(C)
    sd["out.weight"][torch.arange(ng, device=dev),
                     torch.arange(ng, device=dev), 0, 0] = sqrt_c

    # the live parts, each family in one call of one generator
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    sd["encoder.patch_embed.weight"] = randn(E, 3, ps, ps) * (
        w["ripple"] / (sqrt_c * ps))
    qkv = randn(depth, 3 * E, E) / math.sqrt(E)
    proj = randn(depth, E, E) * (
        w["attn_ripple"] / (sqrt_c * math.sqrt(depth) * math.sqrt(E)))
    lin1 = randn(depth, H, E) / math.sqrt(E)
    lin2 = randn(depth, E, H) * (
        w["mlp_ripple"] / (sqrt_c * math.sqrt(depth) * math.sqrt(H)))
    rel = randn(2, depth, 2 * thw - 1, hd) * w["relpos_std"]
    for i in range(depth):
        p = f"encoder.blocks.{i}."
        sd[p + "attn.qkv.weight"] = qkv[i]
        sd[p + "attn.proj.weight"] = proj[i]
        sd[p + "mlp.lin1.weight"] = lin1[i]
        sd[p + "mlp.lin2.weight"] = lin2[i]
        sd[p + "attn.rel_pos_h"] = rel[0, i]
        sd[p + "attn.rel_pos_w"] = rel[1, i]
    if m["n_cell_classes"] > 1:
        nc = m["n_cell_classes"] * ps * ps
        sd["out_class.weight"] = randn(nc, D, 1, 1) * (
            w["class_std"] / math.sqrt(D))
        k = w["dominant_class"]
        sd["out_class.bias"][k * ps * ps:(k + 1) * ps * ps] = w["class_bias"]
    return sd
