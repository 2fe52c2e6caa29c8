"""Vanilla SegNet (port of `autoposeestimation_tpu/models/segnet.py`): the
13-conv VGG16 encoder and its mirrored decoder with max-pooling-indices
unpooling, trained with cross-entropy. NCHW.

The pooling keeps the JAX version's one-hot form: each 2x2 window records
the position of its first maximum (`argmax`; `F.max_pool2d`'s indices make
no such promise on ties) and unpooling puts the value back there. The
pooled maximum is `amax`, whose gradient is shared among tied elements as
JAX's `max` shares it. Each pooling and unpooling in `SegNet.forward` is a
span of the tracer (`utils/timing.py`), 'segnet.pool' and 'segnet.unpool',
five of each a forward."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.timing import span
from .common import BatchNorm2d, Conv2d

ENCODER_WIDTHS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                  (512, 512, 512))
DECODER_WIDTHS = ((512, 512, 512), (512, 512, 256), (256, 256, 128),
                  (128, 64), (64,))


def max_pool_with_indices(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """2x2 stride-2 max pool of (B, C, H, W): (pooled, one-hot positions
    (B, C, H/2, W/2, 4), position = 2 * row + column in the window)."""
    b, c, h, w = x.shape
    blocks = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, h // 2, w // 2, 4)
    idx = torch.argmax(blocks, dim=-1)
    onehot = torch.arange(4, device=x.device) == idx[..., None]
    return blocks.amax(dim=-1), onehot


def max_unpool(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """The inverse of `max_pool_with_indices`: zeros but at the recorded
    positions."""
    b, c, h2, w2 = x.shape
    blocks = x[..., None] * onehot.to(x.dtype)
    return blocks.reshape(b, c, h2, w2, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, 2 * h2, 2 * w2)


class ConvStack(nn.Module):
    """conv3x3 (no bias) - BN (f32) - ReLU per width."""

    def __init__(self, in_ch: int, widths: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        convs, bns = [], []
        for wdt in widths:
            convs.append(Conv2d(in_ch, wdt, 3, 1, 1, bias=False, dtype=dtype))
            bns.append(BatchNorm2d(wdt, torch.float32))
            in_ch = wdt
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return x


class SegNet(nn.Module):
    """13-conv VGG16 encoder + mirrored decoder with index unpooling; f32
    logits. H and W must be multiples of 32."""

    def __init__(self, classes: int = 22, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        stacks, in_ch = [], 3
        for widths in ENCODER_WIDTHS + DECODER_WIDTHS:
            stacks.append(ConvStack(in_ch, widths, dtype))
            in_ch = widths[-1]
        self.encoder = nn.ModuleList(stacks[:len(ENCODER_WIDTHS)])
        self.decoder = nn.ModuleList(stacks[len(ENCODER_WIDTHS):])
        self.head = Conv2d(in_ch, classes, 3, 1, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype)
        indices = []
        for stack in self.encoder:
            y = stack(y)
            with span("segnet.pool"):
                y, onehot = max_pool_with_indices(y)
            indices.append(onehot)
        for stack, onehot in zip(self.decoder, reversed(indices)):
            with span("segnet.unpool"):
                y = max_unpool(y, onehot)
            y = stack(y)
        return self.head(y.to(torch.float32))


def cross_entropy_loss(labels: torch.Tensor,
                       logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross-entropy, mean over (B, H, W); logits (B, C, H, W)."""
    logp = F.log_softmax(logits, dim=1)
    return -logp.gather(1, labels[:, None].to(torch.int64)).mean()
