"""UNet++ with a TF-padding EfficientNet-B0 encoder (counterpart of
``classpose_tpu/grandqc/nets.py``), as ``nn.Module``s in NCHW.

The nets GrandQC builds with segmentation_models_pytorch
(``smp.UnetPlusPlus`` on the ``timm-efficientnet-b0`` encoder): the
2-class tissue model and the 8-class artefact model.

Encoder (timm tf_efficientnet_b0, TF "SAME" padding): stem conv 3→32 s2 +
BN + SiLU, then 7 MBConv stages (channels 16/24/40/80/112/192/320,
strides 1/2/2/2/1/2/1, expansion 1/6/…/6, kernels 3/3/5/3/5/5/3,
squeeze-excite at 0.25 of the block input); the skips are taken at the
first stride-2 block of each reduction, giving smp's pyramid with
channels (3, 32, 24, 40, 112, 320).

Decoder (smp UNet++): nested blocks ``x_{depth}_{layer}``, each nearest
×2 → concat ``[x, *skips]`` → (conv3×3 + BN + ReLU) ×2 with decoder
channels (256, 128, 64, 32, 16); then a conv3×3 head to the classes.

Inference only: BatchNorm uses the stored statistics. The submodules carry
smp's names, so an smp state dict without its ``num_batches_tracked``
counters loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, kernel, stride, expand, n_blocks) — efficientnet-b0
_B0_STAGES = [
    (16, 3, 1, 1, 1),
    (24, 3, 2, 6, 2),
    (40, 5, 2, 6, 2),
    (80, 3, 2, 6, 3),
    (112, 5, 1, 6, 3),
    (192, 5, 2, 6, 4),
    (320, 3, 1, 6, 1),
]

B0_OUT_CHANNELS = (3, 32, 24, 40, 112, 320)  # smp encoder out_channels


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """TF 'SAME' asymmetric padding (timm ``Conv2dSame``)."""
    def amt(size):
        out = -(-size // stride)
        total = max(0, (out - 1) * stride + kernel - size)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = amt(x.shape[2]), amt(x.shape[3])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return x


class ConvSame(nn.Conv2d):
    """A VALID conv after TF 'SAME' padding (no bias unless asked)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=bias)

    def forward(self, x):
        return super().forward(
            _same_pad(x, self.kernel_size[0], self.stride[0]))


class BatchNorm(nn.Module):
    """Inference BatchNorm on the stored statistics, in the JAX order
    ``(x - mean) * (scale / sqrt(var + eps)) + bias``; smp's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return ((x - self.running_mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """timm InvertedResidual (``conv_pw``/``bn1``, ``conv_dw``/``bn2``,
    ``se``, ``conv_pwl``/``bn3``), or at expansion 1 the stage-0
    DepthwiseSeparableConv (``conv_dw``/``bn1``, ``se``,
    ``conv_pw``/``bn2``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 expand: int, se_ratio: float = 0.25):
        super().__init__()
        self.expand = expand
        self.skip = stride == 1 and cin == cout
        mid = cin * expand
        if expand != 1:
            self.conv_pw = ConvSame(cin, mid, 1)
            self.bn1 = BatchNorm(mid)
            self.conv_dw = ConvSame(mid, mid, kernel, stride, groups=mid)
            self.bn2 = BatchNorm(mid)
        else:
            self.conv_dw = ConvSame(cin, cin, kernel, stride, groups=cin)
            self.bn1 = BatchNorm(cin)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        if expand != 1:
            self.conv_pwl = ConvSame(mid, cout, 1)
            self.bn3 = BatchNorm(cout)
        else:
            self.conv_pw = ConvSame(cin, cout, 1)
            self.bn2 = BatchNorm(cout)

    def forward(self, x):
        if self.expand != 1:
            h = F.silu(self.bn1(self.conv_pw(x)))
            h = self.se(F.silu(self.bn2(self.conv_dw(h))))
            h = self.bn3(self.conv_pwl(h))
        else:
            h = self.se(F.silu(self.bn1(self.conv_dw(x))))
            h = self.bn2(self.conv_pw(h))
        return h + x if self.skip else h


class EfficientNetB0Encoder(nn.Module):
    """Returns the smp 6-feature pyramid [x, r2, r4, r8, r16, r32]."""

    def __init__(self):
        super().__init__()
        self.conv_stem = ConvSame(3, 32, 3, 2)
        self.bn1 = BatchNorm(32)
        stages = []
        cin = 32
        for cout, k, stride, expand, n in _B0_STAGES:
            stages.append(nn.Sequential(*[
                MBConv(cin if i == 0 else cout, cout, k,
                       stride if i == 0 else 1, expand)
                for i in range(n)]))
            cin = cout
        self.blocks = nn.Sequential(*stages)

    def forward(self, x):
        feats = [x]
        h = F.silu(self.bn1(self.conv_stem(x)))
        feats.append(h)  # reduction 2, 32 ch
        red, taken = 2, {}
        for stage in self.blocks:
            for block in stage:
                st = block.conv_dw.stride[0]
                if st == 2 and red in (4, 8, 16, 32) and red not in taken:
                    taken[red] = h
                h = block(h)
                red *= st
        return feats + [taken[4], taken[8], taken[16], h]


class DecoderBlock(nn.Module):
    """smp DecoderBlock (attention None): nearest ×2 → concat
    ``[x, *skips]`` (the order the pretrained conv1 kernels expect) →
    Conv2dReLU ×2 (BatchNorm eps 1e-5, torch's default)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvSame(cin, cout, 3),
                                   BatchNorm(cout, eps=1e-5))
        self.conv2 = nn.Sequential(ConvSame(cout, cout, 3),
                                   BatchNorm(cout, eps=1e-5))

    def forward(self, x, skips: list):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if skips:
            x = torch.cat([x, *skips], dim=1)
        return F.relu(self.conv2(F.relu(self.conv1(x))))


@dataclasses.dataclass(frozen=True)
class UnetPlusPlusConfig:
    classes: int = 2
    decoder_channels: tuple = (256, 128, 64, 32, 16)  # smp default
    dtype: str = "float32"


class UnetPlusPlusDecoder(nn.Module):
    """smp's UnetPlusPlusDecoder wiring over the 6-feature pyramid. For
    features reversed to [head, f1, f2, f3, f4] (head deepest) and
    ``skip = [ch(f1), …, ch(f4), 0]``, block ``x_{d}_{L}`` takes
    ``features[d]`` on the diagonal (d == L, skip ``features[d+1]``),
    else ``x_{d}_{L-1}`` with skips ``[x_{i}_{L} for i in d+1..L]`` +
    ``[features[L+1]]``; it has ``dec[L]`` channels at d == 0, else
    ``skip[L]``. The output is ``x_0_{depth}`` of ``x_0_{depth-1}``."""

    def __init__(self, cfg: UnetPlusPlusConfig,
                 encoder_channels=B0_OUT_CHANNELS):
        super().__init__()
        dec = [int(c) for c in cfg.decoder_channels]
        fch = list(encoder_channels[1:])[::-1]
        self.depth = depth = len(dec) - 1
        skip = fch[1:] + [0]
        out_ch: dict[tuple[int, int], int] = {}
        blocks = {}
        for layer in range(depth):
            for d in range(depth - layer):
                L = d + layer
                out_ch[(d, L)] = dec[L] if d == 0 else skip[L]
                if layer == 0:
                    cin = fch[d] + fch[d + 1]
                else:
                    cin = (out_ch[(d, L - 1)]
                           + sum(skip[L] for _ in range(d + 1, L + 1))
                           + fch[L + 1])
                blocks[f"x_{d}_{L}"] = DecoderBlock(cin, out_ch[(d, L)])
        blocks[f"x_0_{depth}"] = DecoderBlock(out_ch[(0, depth - 1)],
                                              dec[depth])
        self.blocks = nn.ModuleDict(blocks)

    def forward(self, feats: list):
        features = feats[1:][::-1]
        depth = self.depth
        dense = {}
        for layer in range(depth):
            for d in range(depth - layer):
                L = d + layer
                if layer == 0:
                    x_in, skips = features[d], [features[d + 1]]
                else:
                    x_in = dense[(d, L - 1)]
                    skips = [dense[(i, L)] for i in range(d + 1, L + 1)]
                    skips.append(features[L + 1])
                dense[(d, L)] = self.blocks[f"x_{d}_{L}"](x_in, skips)
        return self.blocks[f"x_0_{depth}"](dense[(0, depth - 1)], [])


class UnetPlusPlus(nn.Module):
    """smp UnetPlusPlus(timm-efficientnet-b0): encoder pyramid → UNet++
    decoder → 3×3 segmentation head; NCHW logits in fp32."""

    def __init__(self, cfg: UnetPlusPlusConfig = UnetPlusPlusConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = EfficientNetB0Encoder()
        self.decoder = UnetPlusPlusDecoder(cfg)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(int(cfg.decoder_channels[-1]), cfg.classes, 3,
                      padding=1))

    def forward(self, x):
        dt = getattr(torch, self.cfg.dtype)
        out = self.decoder(self.encoder(x.to(dt)))
        return self.segmentation_head(out).float()
