"""Shared model utilities (port of `autoposeestimation_tpu/models/common.py`)
plus the layers that carry flax's `dtype=` meaning: parameters stay f32 and
the compute runs in `dtype`, with inputs and parameters cast on the way in.
Tensors are NCHW."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5  # flax BatchNorm's default epsilon


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """uint8-range RGB (..., 3, H, W) -> normalized f32 (ToTensor+Normalize)."""
    x = img.to(torch.float32) / 255.0
    stats = torch.tensor((IMAGENET_MEAN, IMAGENET_STD), dtype=torch.float32)
    if x.is_cuda:
        # an asynchronous copy from pinned memory: a pageable one waits for
        # the stream, which would stall the serving stream's dispatch
        stats = stats.pin_memory().to(x.device, non_blocking=True)
    return (x - stats[0, :, None, None]) / stats[1, :, None, None]


def _interp_1d_weights(out_size: int, in_size: int, align_corners: bool,
                       device):
    if align_corners and out_size > 1:
        src = (torch.arange(out_size, dtype=torch.float32, device=device)
               * (in_size - 1) / (out_size - 1))
    else:
        scale = in_size / out_size
        src = (torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * scale - 0.5
        src = torch.clamp(src, 0.0, in_size - 1)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    w1 = src - i0.to(torch.float32)
    return i0, i1, 1.0 - w1, w1


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with torch.interpolate's index
    semantics for either `align_corners`. The lerp weights take the input's
    dtype, as in the JAX version (a bf16 map stays bf16)."""
    h, w = x.shape[-2], x.shape[-1]
    r0, r1, wr0, wr1 = _interp_1d_weights(out_hw[0], h, align_corners,
                                          x.device)
    c0, c1, wc0, wc1 = _interp_1d_weights(out_hw[1], w, align_corners,
                                          x.device)
    if x.is_floating_point():
        wr0, wr1 = wr0.to(x.dtype), wr1.to(x.dtype)
        wc0, wc1 = wc0.to(x.dtype), wc1.to(x.dtype)
    xr = (x.index_select(-2, r0) * wr0[:, None]
          + x.index_select(-2, r1) * wr1[:, None])
    return xr.index_select(-1, c0) * wc0 + xr.index_select(-1, c1) * wc1


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of (..., H, W) (U-Net decoder)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """torch AdaptiveAvgPool2d: cell (i, j) averages rows
    [floor(i*H/s), ceil((i+1)*H/s)), the same bounds as the JAX version."""
    return F.adaptive_avg_pool2d(x, out_size)


class Conv2d(nn.Conv2d):
    """Conv2d computing in `dtype` over f32 parameters."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """Linear computing in `dtype` over f32 parameters (flax Dense)."""

    def __init__(self, in_f: int, out_f: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_f, out_f)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d computing in `dtype` over f32 parameters. flax's
    `nn.ConvTranspose((4, 4), strides=2, padding="SAME")` is
    `ConvTranspose2d(in, out, 4, 2, 1)` with the kernel flipped in space
    (`weights.py`'s "convT" conversion)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding)


class BatchNorm2d(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9)` with its arithmetic:
    (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, cast to
    `dtype`. Holds exactly the four entries the JAX tree has.

    In eval mode (`module.eval()`) mean and var are the running statistics.
    In train mode they are the batch's, over (N, H, W) in f32: the mean and
    the biased variance E[x^2] - E[x]^2 clipped at 0, differentiated by
    autograd; the running statistics then move to 0.9 * running + 0.1 *
    batch, the biased variance included (`F.batch_norm` would store the
    unbiased one)."""

    momentum = 0.9

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(self.compute_dtype)


class PReLU(nn.Module):
    """PReLU with one shared slope (init 0.25), applied in the input's
    dtype."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize `module` the way flax initializes its JAX twin:
    LeCun-normal (truncated) kernels, zero biases, unit BN statistics. The
    draws come from `generator` (a CPU generator, so a seed gives the same
    weights on every device). Modules with a `reset_identity` method (the
    refiner's final layers) re-apply their own init afterwards."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            # a transposed conv's weight is (in, out, kh, kw)
            fan_in = (w.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
                      * math.prod(w.shape[2:]))
            # stddev of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            with torch.no_grad():
                cpu = torch.empty(w.shape)
                nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                w.copy_(cpu)
                if m.bias is not None:
                    m.bias.zero_()
    for m in module.modules():
        if hasattr(m, "reset_identity"):
            m.reset_identity()
