"""U-Net-ResNet34, the DenseFusion PSPNet-ResNet18 PoseNet and the
PoseRefineNet in float32 (NCHW images, (B, N, C) point features).

Parameter names follow the measured package's modules, so one state dict
loads into both. Each convolution and dense layer passes its input and its
weight through `self.quant` first: the identity for the reference, a
rounding to a lower precision for the control (`set_quant`). TF32 has to be
off on the card (`exact_f32`) for the identity to mean float32."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


def exact_f32() -> None:
    """Full float32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = largest / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Round(torch.autograd.Function):
    """Operands to float8 e4m3 forward, their gradients to e5m2 backward,
    each under one scale a tensor (its largest magnitude maps to the
    format's largest finite value): fp8 training's usual pair."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x as an fp8 matmul's operand, back in float32."""
    return _Fp8Round.apply(x)


def set_quant(module: nn.Module, fn: Optional[Callable] = None) -> nn.Module:
    """Route the operands of every convolution and dense layer of `module`
    through `fn` (None: float32 as is)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quant = fn or _identity
    return module


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """uint8-range RGB (..., 3, H, W) -> normalized float32."""
    x = img.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


class Conv2d(nn.Conv2d):
    quant = staticmethod(_identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(self.quant(x), self.quant(self.weight),
                                  self.bias)


class Linear(nn.Linear):
    quant = staticmethod(_identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.quant(x), self.quant(self.weight), self.bias)


class BatchNorm2d(nn.Module):
    """flax BatchNorm(momentum=0.9): batch statistics over (N, H, W) with
    the biased variance E[x^2] - E[x]^2 in train mode, running ones in
    eval mode."""

    momentum = 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool) -> torch.Tensor:
    return F.interpolate(x, size=out_hw, mode="bilinear",
                         align_corners=align_corners)


# --------------------------------------------------------------- encoders

class BasicBlockBN(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, features, 1, stride, 0, bias=False),
                BatchNorm2d(features))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """ResNet34 returning the skips at /2, /4, /8, /16, /32."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 in_ch: int = 3):
        super().__init__()
        self.conv1 = Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for stage, (blocks, width) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512))):
            layer = []
            for b in range(blocks):
                layer.append(BasicBlockBN(in_ch, width,
                                          2 if (stage > 0 and b == 0) else 1))
                in_ch = width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x, skip=None):
        x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        if skip is not None:
            x = x[:, :, :skip.shape[2], :skip.shape[3]]
            x = torch.cat([x, skip], dim=1)
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UNet(nn.Module):
    """Normalized NCHW image -> logits (B, classes, H, W) (output stride
    1)."""

    def __init__(self, classes: int,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 encoder_stages: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.encoder = ResNetEncoder(encoder_stages)
        blocks, in_ch = [], 512
        for features, sc in zip(decoder_channels, (256, 128, 64, 64, 0)):
            blocks.append(DecoderBlock(in_ch + sc, features))
            in_ch = features
        self.decoder = nn.ModuleList(blocks)
        self.head = Conv2d(in_ch, classes, 3, 1, 1)

    def forward(self, x):
        feats = self.encoder(x)
        y = feats[4]
        for block, skip in zip(self.decoder, [feats[3], feats[2], feats[1],
                                              feats[0], None]):
            y = block(y, skip)
        return self.head(y)


# ------------------------------------------------------------------ PSPNet

class BasicBlockPlain(nn.Module):
    def __init__(self, in_ch, features, stride=1, dilation=1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, dilation, dilation,
                            bias=False)
        self.conv2 = Conv2d(features, features, 3, 1, dilation, dilation,
                            bias=False)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = Conv2d(in_ch, features, 1, stride, 0,
                                     bias=False)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class DilatedResNetNoBN(nn.Module):
    """BN-free ResNet18, layers 3/4 at stride 1 with dilation 2/4."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        in_ch = 64
        for i, (width, first_stride, dil) in enumerate(
                [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]):
            layer = []
            for b in range(2):
                layer.append(BasicBlockPlain(
                    in_ch, width, first_stride if b == 0 else 1,
                    1 if b == 0 else dil))
                in_ch = width
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax Dropout in training: keep with 1 - rate, scale by 1 / (1 -
    rate); the mask is one `torch.rand` draw of x's shape."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class PSPModule(nn.Module):
    def __init__(self, features=512, out_features=1024, sizes=(1, 2, 3, 6)):
        super().__init__()
        self.sizes = tuple(sizes)
        self.stages = nn.ModuleList(
            Conv2d(features, features, 1, bias=False) for _ in self.sizes)
        self.bottleneck = Conv2d(features * (len(self.sizes) + 1),
                                 out_features, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        priors = [resize_bilinear(conv(F.adaptive_avg_pool2d(x, s)), (h, w),
                                  False)
                  for s, conv in zip(self.sizes, self.stages)]
        priors.append(x)
        return F.relu(self.bottleneck(torch.cat(priors, dim=1)))


class PSPUpsample(nn.Module):
    def __init__(self, in_ch, features, do_resize):
        super().__init__()
        self.do_resize = do_resize
        self.conv = Conv2d(in_ch, features, 3, 1, 1)
        self.prelu = PReLU()

    def forward(self, x):
        if self.do_resize:
            x = resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]), True)
        return self.prelu(self.conv(x))


class PSPNet(nn.Module):
    """log-softmax embeddings (B, 32, S/s, S/s) at `emb_stride` s."""

    dropout_rates = (0.3, 0.15, 0.15)

    def __init__(self, emb_stride: int = 8):
        super().__init__()
        n_resize = {1: 3, 2: 2, 4: 1, 8: 0}[emb_stride]
        self.feats = DilatedResNetNoBN()
        self.psp = PSPModule()
        self.up_1 = PSPUpsample(1024, 256, n_resize > 0)
        self.up_2 = PSPUpsample(256, 64, n_resize > 1)
        self.up_3 = PSPUpsample(64, 64, n_resize > 2)
        self.final = Conv2d(64, 32, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        p = self.psp(self.feats(x))
        for rate, up in zip(self.dropout_rates,
                            (self.up_1, self.up_2, self.up_3)):
            if generator is not None:
                p = dropout(p, rate, generator)
            p = up(p)
        return F.log_softmax(self.final(p), dim=1)


# --------------------------------------------------------------- DenseFusion

def gather_embeddings(emb_map, choose):
    b, e = emb_map.shape[:2]
    idx = choose.to(torch.int64)[:, None, :].expand(b, e, choose.shape[1])
    return torch.gather(emb_map.reshape(b, e, -1), 2, idx).transpose(1, 2)


def gather_embeddings_bilinear(emb_map, choose, crop: int):
    """Bilinear sample of a stride-s map at the crop's chosen pixels, pixel
    centres mapped as (full + 0.5) / s - 0.5, clamped to the map."""
    b, e, hc, wc = emb_map.shape
    s = crop // hc
    fr = torch.clamp((torch.div(choose, crop, rounding_mode="floor").float()
                      + 0.5) / s - 0.5, 0.0, hc - 1.0)
    fc = torch.clamp(((choose % crop).float() + 0.5) / s - 0.5, 0.0,
                     wc - 1.0)
    r0, c0 = torch.floor(fr).long(), torch.floor(fc).long()
    r1, c1 = torch.clamp(r0 + 1, max=hc - 1), torch.clamp(c0 + 1, max=wc - 1)
    wr, wcol = (fr - r0.float())[..., None], (fc - c0.float())[..., None]

    def take(r, c):
        return gather_embeddings(emb_map, r * wc + c)

    top = take(r0, c0) * (1 - wcol) + take(r0, c1) * wcol
    bot = take(r1, c0) * (1 - wcol) + take(r1, c1) * wcol
    return top * (1 - wr) + bot * wr


class PoseNetFeat(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.e_conv1 = Linear(3, 64), Linear(32, 64)
        self.conv2, self.e_conv2 = Linear(64, 128), Linear(64, 128)
        self.conv5, self.conv6 = Linear(256, 512), Linear(512, 1024)

    def forward(self, cloud, emb):
        x, e = F.relu(self.conv1(cloud)), F.relu(self.e_conv1(emb))
        pf1 = torch.cat([x, e], dim=-1)
        x, e = F.relu(self.conv2(x)), F.relu(self.e_conv2(e))
        pf2 = torch.cat([x, e], dim=-1)
        g = F.relu(self.conv6(F.relu(self.conv5(pf2))))
        g = g.mean(dim=1, keepdim=True).expand(-1, pf1.shape[1], -1)
        return torch.cat([pf1, pf2, g], dim=-1)


def _select_object(y, obj_idx, num_obj: int, out_dim: int):
    y = y.reshape(y.shape[:-1] + (num_obj, out_dim))
    idx = obj_idx.long().reshape((-1,) + (1,) * (y.dim() - 1))
    return torch.gather(y, -2, idx.expand(y.shape[:-2] + (1, out_dim))
                        ).squeeze(-2)


class PoseHead(nn.Module):
    def __init__(self, out_dim: int, num_obj: int):
        super().__init__()
        self.out_dim, self.num_obj = out_dim, num_obj
        self.conv1, self.conv2 = Linear(1408, 640), Linear(640, 256)
        self.conv3 = Linear(256, 128)
        self.conv4 = Linear(128, out_dim * num_obj)

    def forward(self, feat, obj_idx):
        y = F.relu(self.conv3(F.relu(self.conv2(F.relu(self.conv1(feat))))))
        return _select_object(self.conv4(y), obj_idx, self.num_obj,
                              self.out_dim)


class PoseNet(nn.Module):
    """(crops, cloud, choose, obj_idx) -> (pred_r, pred_t, pred_c, emb);
    dropout in the PSPNet when a `generator` is given."""

    def __init__(self, num_obj: int, emb_stride: int = 8):
        super().__init__()
        self.emb_stride = emb_stride
        self.cnn = PSPNet(emb_stride)
        self.feat = PoseNetFeat()
        self.head_r = PoseHead(4, num_obj)
        self.head_t = PoseHead(3, num_obj)
        self.head_c = PoseHead(1, num_obj)

    def forward(self, img, cloud, choose, obj_idx, generator=None):
        emb_map = self.cnn(img, generator)
        if self.emb_stride > 1:
            emb = gather_embeddings_bilinear(emb_map, choose, img.shape[-1])
        else:
            emb = gather_embeddings(emb_map, choose)
        feat = self.feat(cloud, emb)
        return (self.head_r(feat, obj_idx), self.head_t(feat, obj_idx),
                torch.sigmoid(self.head_c(feat, obj_idx)), emb.detach())


class PoseRefineNetFeat(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.e_conv1 = Linear(3, 64), Linear(32, 64)
        self.conv2, self.e_conv2 = Linear(64, 128), Linear(64, 128)
        self.conv5, self.conv6 = Linear(384, 512), Linear(512, 1024)

    def forward(self, cloud, emb):
        x, e = F.relu(self.conv1(cloud)), F.relu(self.e_conv1(emb))
        pf1 = torch.cat([x, e], dim=-1)
        x, e = F.relu(self.conv2(x)), F.relu(self.e_conv2(e))
        pf3 = torch.cat([pf1, x, e], dim=-1)
        return F.relu(self.conv6(F.relu(self.conv5(pf3)))).mean(dim=1)


class RefineHead(nn.Module):
    def __init__(self, out_dim: int, num_obj: int):
        super().__init__()
        self.out_dim, self.num_obj = out_dim, num_obj
        self.conv1, self.conv2 = Linear(1024, 512), Linear(512, 128)
        self.conv3 = Linear(128, out_dim * num_obj)

    def forward(self, feat, obj_idx):
        y = F.relu(self.conv2(F.relu(self.conv1(feat))))
        return _select_object(self.conv3(y), obj_idx, self.num_obj,
                              self.out_dim)


class PoseRefineNet(nn.Module):
    def __init__(self, num_obj: int):
        super().__init__()
        self.feat = PoseRefineNetFeat()
        self.head_r = RefineHead(4, num_obj)
        self.head_t = RefineHead(3, num_obj)

    def forward(self, cloud, emb, obj_idx):
        feat = self.feat(cloud, emb)
        return self.head_r(feat, obj_idx), self.head_t(feat, obj_idx)


def fan_in(shape: Sequence[int]) -> int:
    """The fan-in of a convolution or dense weight of `shape`."""
    return int(shape[1] * math.prod(shape[2:]))
