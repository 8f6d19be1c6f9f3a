"""Class-head UNet (counterpart of ``classpose_tpu/nn/unet.py``).

An asymmetric UNet whose encoder "skips" are the downsampled block
outputs, with an extra bottleneck down/up pair, decoder blocks that
upsample at their end, and the last decoder block skipping its final
ReLU. NCHW, as PyTorch convolutions want it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from classpose_tpu_torch.nn.layers import Conv2d, ConvTranspose2d


class UNetBlock(nn.Module):
    """conv3x3 → ReLU → conv3x3 (→ ReLU unless skipped)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)

    def forward(self, x, skip_last_activation: bool = False):
        x = self.conv2(F.relu(self.conv1(x)))
        return x if skip_last_activation else F.relu(x)


class UNetBlockDown(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = UNetBlock(cin, cout)
        self.downconv = Conv2d(cout, cout, 2, stride=2)

    def forward(self, x):
        x = self.block(x)
        return x, self.downconv(x)


class UNetBlockUp(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = UNetBlock(cin, cout)
        self.upconv = ConvTranspose2d(cout, cout, 2, stride=2)

    def forward(self, x, skip_last_activation: bool = False):
        return self.upconv(self.block(x, skip_last_activation))


class UNet(nn.Module):
    """``n_channels`` is the encoder ladder; the decoder mirrors it and
    ends at ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_channels: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        enc = list(n_channels)
        dec = enc[::-1][1:] + [out_channels]
        self.encoder_blocks = nn.ModuleList()
        cin = in_channels
        for c in enc:
            self.encoder_blocks.append(UNetBlockDown(cin, c))
            cin = c
        self.bottleneck_down = UNetBlockDown(enc[-1], enc[-1])
        self.bottleneck_up = UNetBlockUp(enc[-1], enc[-1])
        self.decoder_blocks = nn.ModuleList()
        cin = enc[-1]
        for c, skip in zip(dec, enc[::-1]):
            self.decoder_blocks.append(UNetBlockUp(cin + skip, c))
            cin = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for blk in self.encoder_blocks:
            _, x = blk(x)
            skips.append(x)
        skips = skips[::-1]
        _, x = self.bottleneck_down(x)
        x = self.bottleneck_up(x)
        n = len(self.decoder_blocks)
        for i, blk in enumerate(self.decoder_blocks):
            x = blk(torch.cat([x, skips[i]], dim=1),
                    skip_last_activation=(i == n - 1))
        return x
