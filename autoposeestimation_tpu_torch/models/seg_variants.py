"""The segmentation registry's other models (port of
`autoposeestimation_tpu/models/seg_variants.py`), over the U-Net's
ResNet34-BN encoder, NCHW.

LinkNet: decoder blocks project to in/4 with a 1x1 conv, upsample x2 with a
4x4 stride-2 transposed conv, project to the output width; skips are added.
PSPNet-seg: pyramid pooling (1, 2, 3, 6) on the /8 features, a 3x3 conv,
BN, ReLU, dropout 0.1 (training only, its mask drawn from an explicit
`torch.Generator`), a 1x1 f32 head and a bilinear resize to the input. The
decoders' BatchNorms compute in f32 whatever `dtype` is, as in the JAX
version."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BatchNorm2d, Conv2d, ConvTranspose2d, adaptive_avg_pool,
                     resize_bilinear, upsample_nearest_2x)
from .pspnet import dropout
from .resnet import ResNetEncoder

_F32 = torch.float32


class LinkNetDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_ch // 4
        self.conv1 = Conv2d(in_ch, mid, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(mid, _F32)
        self.deconv = ConvTranspose2d(mid, mid, 4, 2, 1, bias=False,
                                      dtype=dtype)
        self.bn2 = BatchNorm2d(mid, _F32)
        self.conv2 = Conv2d(mid, out_features, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out_features, _F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.deconv(y)))
        return F.relu(self.bn3(self.conv2(y)))


class LinkNet(nn.Module):
    """LinkNet-resnet34; f32 logits at the input's resolution."""

    def __init__(self, classes: int,
                 encoder_stages: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, in_ch: int = 3):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNetEncoder(encoder_stages, dtype, in_ch)
        self.decoder = nn.ModuleList([
            LinkNetDecoderBlock(cin, cout, dtype)
            for cin, cout in ((512, 256), (256, 128), (128, 64), (64, 64))])
        self.head = Conv2d(64, classes, 3, 1, 1, dtype=_F32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        y = feats[4]                                   # /32
        for block, skip in zip(self.decoder, feats[3::-1]):
            y = block(y) + skip.to(self.dtype)         # /16, /8, /4, /2
        return self.head(upsample_nearest_2x(y).to(_F32))


class PSPNetSeg(nn.Module):
    """PSPNet segmentation head over the ResNet34 encoder's /8 features.
    In train mode its dropout needs a `generator` (the JAX version needs a
    dropout key alike)."""

    def __init__(self, classes: int,
                 encoder_stages: Sequence[int] = (3, 4, 6, 3),
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32, in_ch: int = 3):
        super().__init__()
        self.dtype = dtype
        self.sizes = tuple(sizes)
        self.encoder = ResNetEncoder(encoder_stages, dtype, in_ch)
        self.stages = nn.ModuleList([Conv2d(128, 128, 1, bias=False,
                                            dtype=dtype) for _ in sizes])
        self.bottleneck = Conv2d(128 * (len(sizes) + 1), 512, 3, 1, 1,
                                 bias=False, dtype=dtype)
        self.bn = BatchNorm2d(512, _F32)
        self.head = Conv2d(512, classes, 1, dtype=_F32)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and generator is None:
            raise ValueError("PSPNetSeg in train mode needs a generator for "
                             "its dropout")
        h, w = x.shape[-2:]
        f = self.encoder(x)[2]                         # /8, 128 channels
        fh, fw = f.shape[-2:]
        priors = [f]
        for s, conv in zip(self.sizes, self.stages):
            p = conv(adaptive_avg_pool(f, s))
            priors.append(resize_bilinear(p, (fh, fw)).to(self.dtype))
        y = F.relu(self.bn(self.bottleneck(torch.cat(priors, dim=1))))
        if self.training:
            y = dropout(y, 0.1, generator)
        return resize_bilinear(self.head(y.to(_F32)), (h, w))
