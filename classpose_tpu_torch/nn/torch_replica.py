"""Independent PyTorch replicas of the network architectures, with the
upstream state-dict naming (cellpose/SAM for the ClassTransformer, smp for
the GrandQC UNet++ tail): a copy of the JAX package's
``nn/torch_replica.py``.

The numeric-parity oracle of ``entrypoints/parity_check.py``: a published
checkpoint loads into the replica under its own key names, with no name
map, and into the port's ``ClassTransformer`` through
``nn/convert.py``'s map; the two forwards must agree at fp32. This
mirrors the architecture contract of the reference (vit_sam.py:148-197 +
the cellpose/SAM encoder it builds on), written fresh. Nothing on the
inference path imports it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    max_rel_dist = 2 * max(q_size, k_size) - 1
    assert rel_pos.shape[0] == max_rel_dist
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class RefAttention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim**-0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = True
        self.rel_pos_h = nn.Parameter(
            torch.zeros(2 * input_size[0] - 1, head_dim)
        )
        self.rel_pos_w = nn.Parameter(
            torch.zeros(2 * input_size[1] - 1, head_dim)
        )

    def forward(self, x):
        B, H, W, _ = x.shape
        L = H * W
        qkv = (
            self.qkv(x).reshape(B, L, 3, self.num_heads, -1)
            .permute(2, 0, 3, 1, 4)
        )
        q, k, v = qkv.unbind(0)
        head_dim = q.shape[-1]
        q_hw = q.reshape(B, self.num_heads, H, W, head_dim)
        Rh = get_rel_pos(H, H, self.rel_pos_h)
        Rw = get_rel_pos(W, W, self.rel_pos_w)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", q_hw, Rh)
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", q_hw, Rw)
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
            B, self.num_heads, L, L
        )
        x = F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, dropout_p=0.0, scale=self.scale
        )
        x = x.transpose(1, 2).reshape(B, H, W, -1)
        return self.proj(x)


class RefMLP(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class RefBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, input_size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = RefAttention(dim, num_heads, input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = RefMLP(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    def __init__(self, num_channels, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class RefEncoder(nn.Module):
    def __init__(self, ps, bsize, embed_dim, depth, num_heads, mlp_ratio,
                 neck_dim):
        super().__init__()
        thw = bsize // ps
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(
            3, embed_dim, kernel_size=ps, stride=ps
        )
        self.pos_embed = nn.Parameter(
            torch.zeros(1, thw, thw, embed_dim)
        )
        self.blocks = nn.ModuleList(
            [
                RefBlock(embed_dim, num_heads, mlp_ratio, (thw, thw))
                for _ in range(depth)
            ]
        )
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, neck_dim, 1, bias=False),
            LayerNorm2d(neck_dim),
            nn.Conv2d(neck_dim, neck_dim, 3, padding=1, bias=False),
            LayerNorm2d(neck_dim),
        )

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class RefUNetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, x, skip_last=False):
        x = F.relu(self.conv1(x))
        x = self.conv2(x)
        return x if skip_last else F.relu(x)


class RefUNetDown(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.block = RefUNetBlock(cin, cout)
        self.downconv = nn.Conv2d(cout, cout, 2, stride=2)

    def forward(self, x):
        x = self.block(x)
        return x, self.downconv(x)


class RefUNetUp(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.block = RefUNetBlock(cin, cout)
        self.upconv = nn.ConvTranspose2d(cout, cout, 2, stride=2)

    def forward(self, x, skip_last=False):
        return self.upconv(self.block(x, skip_last))


class RefUNet(nn.Module):
    def __init__(self, cin, cout, n_channels):
        super().__init__()
        seq_in = [cin, *n_channels]
        seq_out = [*n_channels[::-1], cout]
        self.encoder_blocks = nn.ModuleList(
            [RefUNetDown(a, b) for a, b in zip(seq_in[:-1], seq_in[1:])]
        )
        self.decoder_blocks = nn.ModuleList(
            [RefUNetUp(a * 2, b) for a, b in zip(seq_out[:-1], seq_out[1:])]
        )
        self.bottleneck_down = RefUNetDown(seq_in[-1], seq_in[-1])
        self.bottleneck_up = RefUNetUp(seq_in[-1], seq_in[-1])

    def forward(self, x):
        skips = []
        for blk in self.encoder_blocks:
            _, x = blk(x)
            skips.append(x)
        skips = skips[::-1]
        _, x = self.bottleneck_down(x)
        x = self.bottleneck_up(x)
        n = len(self.decoder_blocks)
        for i, blk in enumerate(self.decoder_blocks):
            x = blk(torch.cat((x, skips[i]), 1), skip_last=(i == n - 1))
        return x


class RefClassTransformer(nn.Module):
    def __init__(self, ps=8, bsize=256, nout=3, n_cell_classes=1,
                 structure=None, embed_dim=1024, depth=24, num_heads=16,
                 mlp_ratio=4.0, neck_dim=256):
        super().__init__()
        self.ps = ps
        self.n_cell_classes = n_cell_classes
        # cellpose's Transformer registers these as requires_grad=False
        # Parameters (reference train.py:440 writes net.diam_labels.data;
        # inference rescale is the fixed 30.0/diameter, models.py:634) —
        # they appear in every real checkpoint's state_dict
        self.diam_mean = nn.Parameter(
            torch.ones(1) * 30.0, requires_grad=False
        )
        self.diam_labels = nn.Parameter(
            torch.ones(1) * 30.0, requires_grad=False
        )
        self.encoder = RefEncoder(
            ps, bsize, embed_dim, depth, num_heads, mlp_ratio, neck_dim
        )
        self.out = nn.Conv2d(neck_dim, nout * ps**2, 1)
        self.W2 = nn.Parameter(
            torch.eye(nout * ps**2).reshape(nout * ps**2, nout, ps, ps),
            requires_grad=False,
        )
        if n_cell_classes > 1:
            if structure is not None:
                self.out_class = RefUNet(
                    neck_dim, n_cell_classes * ps**2, list(structure)
                )
            else:
                self.out_class = nn.Conv2d(
                    neck_dim, n_cell_classes * ps**2, 1
                )
            self.W3 = nn.Parameter(
                torch.eye(n_cell_classes * ps**2).reshape(
                    n_cell_classes * ps**2, n_cell_classes, ps, ps
                ),
                requires_grad=False,
            )

    def forward(self, x):
        f = self.encoder(x)
        x1 = F.conv_transpose2d(self.out(f), self.W2, stride=self.ps)
        if self.n_cell_classes > 1:
            x2 = F.conv_transpose2d(
                self.out_class(f), self.W3, stride=self.ps
            )
            return torch.cat((x2, x1), 1)
        return x1


def euler_oracle(dP, iscell, niter=200):
    """Sequential bilinear Euler flow integration — the torch oracle for
    ``classpose_tpu.dynamics.masks.follow_flows`` (cellpose
    ``steps2D_interp`` semantics: exactly ``niter`` explicit steps, flows
    bilinearly sampled at the current positions, positions clipped to the
    image each step)."""
    import numpy as np

    H, W = iscell.shape
    u = torch.from_numpy(
        (np.asarray(dP, np.float32) * np.asarray(iscell)[None] / 5.0)
        .astype(np.float32)
    )
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32),
        torch.arange(W, dtype=torch.float32),
        indexing="ij",
    )
    p = torch.stack([yy, xx])
    fld = u.unsqueeze(0)  # (1, 2, H, W)
    for _ in range(niter):
        gx = p[1] / (W - 1) * 2 - 1
        gy = p[0] / (H - 1) * 2 - 1
        grid = torch.stack([gx, gy], dim=-1).unsqueeze(0)  # (1, H, W, 2)
        s = torch.nn.functional.grid_sample(
            fld, grid, mode="bilinear", padding_mode="border",
            align_corners=True,
        )[0]
        p = torch.stack(
            [
                torch.clamp(p[0] + s[0], 0, H - 1),
                torch.clamp(p[1] + s[1], 0, W - 1),
            ]
        )
    return p.numpy()


# ---------------------------------------------------------------- GrandQC
# smp UnetPlusPlus decoder replica (attention=None) with smp's state-dict
# naming (decoder.blocks.x_{depth}_{layer}.conv{1,2}.{0,1}) — the oracle
# for the GrandQC Zenodo checkpoint graft (reference builds
# smp.UnetPlusPlus(timm-efficientnet-b0), wsi_tissue_detection.py:86-95).


class RefSmpDecoderBlock(nn.Module):
    def __init__(self, in_ch, skip_ch, out_ch):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_ch + skip_ch, out_ch, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )
        self.conv2 = nn.Sequential(
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False),
            nn.BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class _RefSmpUnetPlusPlusDecoder(nn.Module):
    """smp UnetPlusPlusDecoder channel spec + the (unique) dataflow it
    admits. Consumes the 6-feature encoder pyramid."""

    def __init__(self, encoder_channels=(3, 32, 24, 40, 112, 320),
                 decoder_channels=(256, 128, 64, 32, 16)):
        super().__init__()
        ec = list(encoder_channels[1:])[::-1]
        head_ch = ec[0]
        in_channels = [head_ch] + list(decoder_channels[:-1])
        skip_channels = ec[1:] + [0]
        out_channels = list(decoder_channels)
        self.depth = len(in_channels) - 1
        blocks = {}
        for L in range(self.depth):
            for d in range(L + 1):
                if d == 0:
                    in_ch = in_channels[L]
                    skip_ch = skip_channels[L] * (L + 1)
                    out_ch = out_channels[L]
                else:
                    out_ch = skip_channels[L]
                    skip_ch = skip_channels[L] * (L + 1 - d)
                    in_ch = skip_channels[L - 1]
                blocks[f"x_{d}_{L}"] = RefSmpDecoderBlock(
                    in_ch, skip_ch, out_ch
                )
        blocks[f"x_0_{self.depth}"] = RefSmpDecoderBlock(
            in_channels[-1], 0, out_channels[-1]
        )
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, feats):
        features = list(feats[1:])[::-1]
        dense = {}
        for layer in range(self.depth):
            for d in range(self.depth - layer):
                L = d + layer
                if layer == 0:
                    dense[(d, L)] = self.blocks[f"x_{d}_{L}"](
                        features[d], features[d + 1]
                    )
                else:
                    skip = torch.cat(
                        [dense[(i, L)] for i in range(d + 1, L + 1)]
                        + [features[L + 1]],
                        dim=1,
                    )
                    dense[(d, L)] = self.blocks[f"x_{d}_{L}"](
                        dense[(d, L - 1)], skip
                    )
        return self.blocks[f"x_0_{self.depth}"](dense[(0, self.depth - 1)])


class RefSmpUnetPlusPlusTail(nn.Module):
    """decoder + segmentation head with smp's exact state-dict names."""

    def __init__(self, classes=2, encoder_channels=(3, 32, 24, 40, 112, 320),
                 decoder_channels=(256, 128, 64, 32, 16)):
        super().__init__()
        self.decoder = _RefSmpUnetPlusPlusDecoder(
            encoder_channels, decoder_channels
        )
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], classes, 3, padding=1)
        )

    def forward(self, feats):
        return self.segmentation_head(self.decoder(feats))


def randomize_bn_stats(module: nn.Module, seed: int = 0) -> None:
    """Give every BatchNorm non-trivial running statistics so parity tests
    exercise the eps/statistics math, not just the conv kernels."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.running_mean.copy_(
                torch.randn(m.running_mean.shape, generator=g) * 0.2
            )
            m.running_var.copy_(
                torch.rand(m.running_var.shape, generator=g) * 2 + 0.5
            )
            m.weight.data.copy_(
                torch.randn(m.weight.shape, generator=g) * 0.3 + 1
            )
            m.bias.data.copy_(torch.randn(m.bias.shape, generator=g) * 0.2)
