"""Shared model utilities (port of `autoposeestimation_tpu/models/common.py`)
plus the layers that carry flax's `dtype=` meaning: parameters stay f32 and
the compute runs in `dtype`, with inputs and parameters cast on the way in.
Tensors are NCHW. The parallel pieces of `parallel/mesh.py` live here too:
BatchNorm's statistics over a data group and the column-parallel
`Linear`."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5  # flax BatchNorm's default epsilon

_IMAGENET_STATS: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _imagenet_stats(device: torch.device):
    """(mean, std), each f32 (3, 1, 1) on `device`, uploaded once a device
    and kept there: a frame graph captured on the card reads them where
    they lie on every replay (a copy captured from a temporary host buffer
    would read freed memory)."""
    stats = _IMAGENET_STATS.get(device)
    if stats is None:
        with torch.inference_mode(False):   # usable by autograd later
            t = torch.tensor((IMAGENET_MEAN, IMAGENET_STD),
                             dtype=torch.float32)[:, :, None, None]
            stats = _IMAGENET_STATS[device] = tuple(t.to(device))
    return stats


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """uint8-range RGB (..., 3, H, W) -> normalized f32 (ToTensor+Normalize)."""
    x = img.to(torch.float32) / 255.0
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


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


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the 'model' group
    backward (each rank's slice of the output gives part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last dimension over the 'model' group forward;
    backward keeps this rank's slice (every rank holds the same gradient
    of the gathered output)."""

    @staticmethod
    def forward(ctx, y, group, size, index):
        ctx.index, ctx.width = index, y.shape[-1]
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None, None, None


class ColumnParallelLinear(Linear):
    """A `Linear` whose output features are split over a 'model' group of
    `size` ranks, Megatron's column-parallel layer: rank `index` keeps rows
    [index * out / size, (index + 1) * out / size) of the weight and bias,
    multiplies its slice and all-gathers the outputs, so that every rank
    returns the full output. `out_features` stays the logical width.
    `state_dict()` holds this rank's rows; `full_weight()` /
    `full_bias()` gather them back (a collective over the group)."""

    @classmethod
    def from_linear(cls, lin: Linear, group, size: int, index: int,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> "ColumnParallelLinear":
        if lin.out_features % size:
            raise ValueError(f"{lin.out_features} output features do not "
                             f"split over {size} ranks")
        per = lin.out_features // size
        rows = slice(index * per, (index + 1) * per)
        layer = cls.__new__(cls)
        nn.Module.__init__(layer)
        layer.in_features, layer.out_features = (lin.in_features,
                                                 lin.out_features)
        layer.compute_dtype = lin.compute_dtype
        layer.group, layer.size, layer.index = group, size, index
        for name in ("weight", "bias"):
            p = getattr(lin, name)
            p.data = p.data[rows].clone()
            state = {} if optimizer is None else optimizer.state.get(p, {})
            for key, val in state.items():
                if torch.is_tensor(val) and val.dim() >= 1:
                    state[key] = val[rows].clone()
            p.tp_shard = layer
            setattr(layer, name, p)
        return layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = _CopyToModel.apply(x.to(dt), self.group)
        y = F.linear(x, self.weight.to(dt), self.bias.to(dt))
        return _GatherFromModel.apply(y, self.group, self.size, self.index)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (weight- or bias-shaped) tensor -> the
        full tensor, from every rank of the group."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=self.group)
        return torch.cat(parts)

    def full_weight(self) -> torch.Tensor:
        return self.gather_rows(self.weight)

    def full_bias(self) -> torch.Tensor:
        return self.gather_rows(self.bias)


def full_tensor(param: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t` (the parameter or a tensor shaped like it) at the parameter's
    logical shape: gathered over the 'model' group when the parameter is
    a column-parallel shard, else `t` itself."""
    layer = getattr(param, "tp_shard", None)
    return t if layer is None else layer.gather_rows(t)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every column-parallel weight and bias
    gathered back to its full rows: the same keys and shapes as the
    unsharded module. A collective over each sharded layer's group, so
    every rank of it must call it."""
    state = module.state_dict()
    for name, sub in module.named_modules():
        if isinstance(sub, ColumnParallelLinear):
            prefix = f"{name}." if name else ""
            state[prefix + "weight"] = sub.full_weight()
            state[prefix + "bias"] = sub.full_bias()
    return state


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
    unbiased one).

    With a `sync_group` (set by `sync_batchnorm`) the train-mode statistics
    are the global batch's over the ranks of that group: the per-channel
    sums, sums of squares and counts are all-reduced, differentiably, so
    each rank's gradient carries every rank's share and the running
    statistics move alike everywhere (flax's under the JAX package's data
    mesh)."""

    momentum = 0.9

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.compute_dtype = dtype
        self.sync_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.training and self.sync_group is not None:
            c = xf.shape[1]
            count = xf.new_full((1,), float(xf.numel() // c))
            sums = dist_fn.all_reduce(torch.cat(
                [xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
                group=self.sync_group)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean,
                              min=0.0)
        elif self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
        if self.training:
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


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Make every `BatchNorm2d` of `module` take its train-mode statistics
    over the ranks of `group` (None: this rank's batch alone)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return module


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
