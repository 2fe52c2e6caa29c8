"""ResNet encoders (port of `autoposeestimation_tpu/models/resnet.py`): the
BatchNorm torchvision family for the U-Net encoder (its BatchNorms follow
the module's `train()` / `eval()` mode), and the BN-free dilated ResNet18
of the DenseFusion PSPNet. Submodule names follow torchvision (`conv1`,
`layer1.0.bn2`, `downsample.0`)."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm2d, Conv2d


class BasicBlockBN(nn.Module):
    """conv-bn-relu-conv-bn + (projected) identity, relu."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm2d(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm2d(features, dtype)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, features, 1, stride, 0, bias=False, dtype=dtype),
                BatchNorm2d(features, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet18/34 encoder returning the five U-Net skips [/2, /4, /8, /16,
    /32]; the max-pool is 3x3 stride 2 with -inf padding. `in_ch` is the
    input's channel count (flax takes it from the input)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, in_ch: int = 3):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype)
        in_ch = 64
        for stage, (blocks, width) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                layer.append(BasicBlockBN(in_ch, width, stride, dtype))
                in_ch = width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


class BasicBlockPlain(nn.Module):
    """PSPNet block without BatchNorm: conv-relu-conv (+ 1x1 projection),
    optional dilation."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, dilation, dilation,
                            bias=False, dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, 1, dilation, dilation,
                            bias=False, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = Conv2d(in_ch, features, 1, stride, 0,
                                     bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class DilatedResNetNoBN(nn.Module):
    """BN-free ResNet18 with layers 3/4 at stride 1, dilation 2/4: output
    stride 8, 512 channels. The first block of each layer is undilated."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        in_ch = 64
        specs = [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
        for i, ((width, first_stride, dil), blocks) in enumerate(
                zip(specs, stage_sizes)):
            layer = []
            for b in range(blocks):
                layer.append(BasicBlockPlain(
                    in_ch, width, stride=first_stride if b == 0 else 1,
                    dilation=1 if b == 0 else dil, dtype=dtype))
                in_ch = width
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x
