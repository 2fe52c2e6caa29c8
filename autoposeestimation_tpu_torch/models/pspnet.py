"""PSPNet colour-embedding network of DenseFusion (port of
`autoposeestimation_tpu/models/pspnet.py`): dilated BN-free ResNet18 ->
pyramid pooling (1, 2, 3, 6) -> 1x1 bottleneck to 1024 -> three
(2x bilinear + conv3x3 + PReLU) stages -> 1x1 conv to 32 + log_softmax.
Submodule names follow DenseFusion's `lib/pspnet.py` (`feats`, `psp.stages`,
`psp.bottleneck`, `up_1..3`, `final`). Dropout (training only) is
elementwise like flax's, with its masks drawn from an explicit
`torch.Generator`."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, PReLU, adaptive_avg_pool, resize_bilinear
from .resnet import DilatedResNetNoBN


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax `nn.Dropout` in training: each element kept with probability
    1 - rate and scaled by 1 / (1 - rate); rate 0 is the identity and draws
    nothing. `rows` = (n, lo) says that `x` holds rows [lo, lo + len(x))
    of a batch of n split over data-parallel ranks: the mask is drawn for
    all n rows and this block kept, so every rank's generator moves alike
    and the masks are a single device's."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    n, lo = rows if rows is not None else (x.shape[0], 0)
    mask = torch.rand((n,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device)[lo:lo + x.shape[0]] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class PSPModule(nn.Module):
    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes: Sequence[int] = (1, 2, 3, 6),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sizes = tuple(sizes)
        self.dtype = dtype
        self.stages = nn.ModuleList(
            Conv2d(features, features, 1, bias=False, dtype=dtype)
            for _ in self.sizes)
        self.bottleneck = Conv2d(features * (len(self.sizes) + 1),
                                 out_features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2], x.shape[-1]
        priors = [
            # F.upsample's bilinear default, align_corners=False
            resize_bilinear(conv(adaptive_avg_pool(x, s)), (h, w),
                            align_corners=False).to(self.dtype)
            for s, conv in zip(self.sizes, self.stages)]
        priors.append(x)
        return F.relu(self.bottleneck(torch.cat(priors, dim=1)))


class PSPUpsample(nn.Module):
    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32, do_resize: bool = True):
        super().__init__()
        self.do_resize = do_resize
        self.conv = Conv2d(in_ch, features, 3, 1, 1, dtype=dtype)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.do_resize:
            h, w = x.shape[-2], x.shape[-1]
            x = resize_bilinear(x, (2 * h, 2 * w), align_corners=True)
        return self.prelu(self.conv(x))


class PSPNet(nn.Module):
    """Per-pixel 32-d log-softmax embeddings (B, 32, H/s, W/s) for
    `emb_stride` s in {1, 2, 4, 8}. The stride only drops 2x resizes (the
    parameter set is the same for every stride); `resize_late` puts the
    remaining resizes at the last decoder stages instead of the first.
    `train=True` applies dropout after the PSP module and after `up_1` and
    `up_2` at `dropout_rates` (JAX pspnet.py:120-124), over a
    data-parallel batch's `rows` (see `dropout`)."""

    def __init__(self, embed_dim: int = 32, dtype: torch.dtype = torch.float32,
                 emb_stride: int = 1, resize_late: bool = False):
        super().__init__()
        if emb_stride not in (1, 2, 4, 8):
            raise ValueError(f"emb_stride must be 1, 2, 4 or 8: {emb_stride}")
        n_resize = {1: 3, 2: 2, 4: 1, 8: 0}[emb_stride]
        if resize_late:
            do_resize = [i >= 3 - n_resize for i in range(3)]
        else:
            do_resize = [n_resize > i for i in range(3)]
        self.dtype = dtype
        self.feats = DilatedResNetNoBN(dtype=dtype)
        self.psp = PSPModule(512, 1024, dtype=dtype)
        self.up_1 = PSPUpsample(1024, 256, dtype, do_resize[0])
        self.up_2 = PSPUpsample(256, 64, dtype, do_resize[1])
        self.up_3 = PSPUpsample(64, 64, dtype, do_resize[2])
        self.final = Conv2d(64, embed_dim, 1, dtype=torch.float32)
        self.dropout_rates = (0.3, 0.15, 0.15)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if train and generator is None:
            raise ValueError("train=True needs a generator for dropout")
        p = self.psp(self.feats(x.to(self.dtype)))
        for rate, up in zip(self.dropout_rates,
                            (self.up_1, self.up_2, self.up_3)):
            if train:
                p = dropout(p, rate, generator, rows)
            p = up(p)
        return F.log_softmax(self.final(p.to(torch.float32)), dim=1)
