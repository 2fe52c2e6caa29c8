"""U-Net with a ResNet34 encoder (port of `autoposeestimation_tpu/models/
unet.py`): five decoder blocks (256, 128, 64, 32, 16), each nearest-2x
upsample, crop to the skip, concat, two conv-BN-ReLU; a 3x3 f32 head. NCHW
in, NCHW logits out. The BatchNorms follow the module's `train()` /
`eval()` mode.

`out_stride` s in {1, 2, 4, 8} stops the decoder's upsampling once its
lattice reaches 1/s: a block whose nominal output would be finer stays on
the 1/s lattice, its encoder skip subsampled to it, and the head emits
logits at (ceil(H/s), ceil(W/s)). The parameters are the same at every
stride, so trained weights serve at any of them."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2d, upsample_nearest_2x
from .resnet import ResNetEncoder


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, 1, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(features, dtype)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                upsample: bool = True, pool_skip: int = 1) -> torch.Tensor:
        if upsample:
            x = upsample_nearest_2x(x)
        if skip is not None:
            if pool_skip > 1:
                # the block stays on x's coarser lattice: strided nearest
                # subsampling gives the encoder's ceil-mode sizes exactly,
                # len(range(0, ceil(H/2), 2)) == ceil(H/4)
                skip = skip[..., ::pool_skip, ::pool_skip]
            # ceil-mode stride-2 encoders overshoot on odd dims (15 -> 8 ->
            # 16): crop to the skip
            x = x[:, :, :skip.shape[2], :skip.shape[3]]
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UNet(nn.Module):
    """Input normalized NCHW f32 with `in_ch` channels (7 for the
    background-subtraction model); output f32 logits (B, classes,
    ceil(H / out_stride), ceil(W / out_stride))."""

    def __init__(self, classes: int,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 encoder_stages: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, in_ch: int = 3,
                 out_stride: int = 1):
        super().__init__()
        if out_stride not in (1, 2, 4, 8):
            raise ValueError(f"out_stride must be 1, 2, 4 or 8: {out_stride}")
        self.out_stride = out_stride
        self.encoder = ResNetEncoder(encoder_stages, dtype, in_ch)
        skip_ch = (256, 128, 64, 64, 0)
        blocks, in_ch = [], 512
        for features, sc in zip(decoder_channels, skip_ch):
            blocks.append(DecoderBlock(in_ch + sc, features, dtype))
            in_ch = features
        self.decoder = nn.ModuleList(blocks)
        self.head = Conv2d(in_ch, classes, 3, 1, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        skips = [feats[3], feats[2], feats[1], feats[0], None]
        y = feats[4]
        # each block's nominal output lattice
        for block, skip, nominal in zip(self.decoder, skips,
                                        (16, 8, 4, 2, 1)):
            if nominal >= self.out_stride:
                y = block(y, skip)
            else:
                y = block(y, skip, upsample=False,
                          pool_skip=self.out_stride // nominal)
        return self.head(y.to(torch.float32))
