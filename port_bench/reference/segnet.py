"""DenseFusion's vanilla SegNet for YCB-Video in plain PyTorch float32
(https://github.com/j96w/DenseFusion, `vanilla_segmentation/segnet.py`:
`SegNet(input_nbr=3, label_nbr=22)`; `loss.py`; `train.py`'s Adam): its
forward in train mode, its loss and its Adam step.

The 13 convolutions of VGG16 (3x3, padding 1), each followed by
BatchNorm and ReLU, with a 2x2 max pool after each of the five stages,
whose indices (`F.max_pool2d(..., return_indices=True)`) the mirrored
decoder's `F.max_unpool2d` puts the values back at; a 3x3 convolution with
a bias gives the classes. The loss is the cross-entropy averaged over
every pixel of the batch; Adam (0.9, 0.999, eps 1e-8) in plain tensor
arithmetic. Parameter names follow the measured package's SegNet
(`encoder.<i>.convs.<j>`, `encoder.<i>.bns.<j>`, `decoder.…`, `head`), so
one state dict loads into both. Each convolution passes its input and its
weight through `quant` first: the identity for the reference, a rounding to
a lower precision for a control (`set_quant`). On the card TF32 has to be
off (`exact_f32`) for the identity to mean float32.

Departures from the published network:

- No bias on the 26 convolutions that BatchNorm follows. The measured
  package has none; in train mode BatchNorm subtracts the batch mean, which
  cancels a bias, and the bias's gradient is 0.
- BatchNorm keeps flax's running variance, the biased one (torch's
  `BatchNorm2d` keeps the unbiased). Train mode reads neither; the running
  variance is not compared.
- Pooling ties. `F.max_pool2d` sends a tied window's gradient to the one
  position it records; the measured package records its first maximum too
  and unpools there, but splits the pooled maximum's gradient among the tied
  positions. Windows tied at 0 after ReLU, which are common, do not matter:
  ReLU passes no gradient at 0. The program computes its convolutions in
  bfloat16, so values that differ in float32 can tie there; how often is
  measured on the card (PERF.md, `segnet_ycb22`).

The tier-1 tests (`tests/test_torch_segnet_plain.py`) load this file by
its path too; it imports only torch."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

ENCODER_WIDTHS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                  (512, 512, 512))
DECODER_WIDTHS = ((512, 512, 512), (512, 512, 256), (256, 256, 128),
                  (128, 64), (64,))
BN_EPS = 1e-5
BETAS, EPS = (0.9, 0.999), 1e-8


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
    format's largest finite value)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x as an fp8 convolution's operand, back in float32."""
    return _Fp8Round.apply(x)


class Conv2d(nn.Conv2d):
    quant = staticmethod(_identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(self.quant(x), self.quant(self.weight),
                                  self.bias)


def set_quant(module: nn.Module, fn: Optional[Callable] = None) -> nn.Module:
    """Route the operands of every convolution of `module` through `fn`
    (None: float32 as is)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.quant = fn or _identity
    return module


class BatchNorm2d(nn.Module):
    """Train mode: the batch's mean and biased variance E[x^2] - E[x]^2
    over (N, H, W); the running statistics move by a tenth."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvStack(nn.Module):
    """conv3x3 - BN - ReLU per width."""

    def __init__(self, in_ch: int, widths: Sequence[int]):
        super().__init__()
        convs, bns = [], []
        for width in widths:
            convs.append(Conv2d(in_ch, width, 3, 1, 1, bias=False))
            bns.append(BatchNorm2d(width))
            in_ch = width
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = F.relu(bn(conv(x)))
        return x


class SegNet(nn.Module):
    """Logits (B, classes, H, W) of images (B, 3, H, W); H and W multiples
    of 32."""

    def __init__(self, classes: int = 22):
        super().__init__()
        stacks, in_ch = [], 3
        for widths in ENCODER_WIDTHS + DECODER_WIDTHS:
            stacks.append(ConvStack(in_ch, widths))
            in_ch = widths[-1]
        self.encoder = nn.ModuleList(stacks[:len(ENCODER_WIDTHS)])
        self.decoder = nn.ModuleList(stacks[len(ENCODER_WIDTHS):])
        self.head = Conv2d(in_ch, classes, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        indices = []
        for stack in self.encoder:
            x, idx = F.max_pool2d(stack(x), 2, 2, return_indices=True)
            indices.append(idx)
        for stack, idx in zip(self.decoder, reversed(indices)):
            x = stack(F.max_unpool2d(x, idx, 2, 2))
        return self.head(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """The mean over every pixel of the batch (loss.py's CrossEntropyLoss
    over (B * H * W, classes))."""
    return F.cross_entropy(logits, labels)


class Adam:
    """torch.optim.Adam's update in plain arithmetic (its first moment moved
    by `lerp`, as torch moves it), from step `t` with
    moments `m`, `v` ({leaf: tensor}; zeros where None or a leaf is
    missing). `lr` is rounded to float32."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 t: int = 0, m=None, v=None):
        self.params = params
        self.lr = float(torch.tensor(lr, dtype=torch.float32))
        self.t = t
        m, v = m or {}, v or {}
        self.m = {k: m[k].clone() if k in m else torch.zeros_like(p)
                  for k, p in params.items()}
        self.v = {k: v[k].clone() if k in v else torch.zeros_like(p)
                  for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = BETAS
        for k, g in grads.items():
            self.m[k].lerp_(g, 1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(EPS)
            self.params[k].addcdiv_(self.m[k], denom,
                                    value=-self.lr / (1 - b1 ** self.t))


def run_steps(net: SegNet, batches: List[Dict[str, torch.Tensor]],
              lr: float, adam: Optional[Dict] = None) -> Dict:
    """Train-mode steps of `net` on `batches` ({'image', 'label'}) in
    order, from its present parameters, which they update in place; `adam`
    {'t', 'm', 'v'} is the optimizer's state to start from (a fresh one
    where None). Returns {'losses' [per step, before its update],
    'first_grad' {leaf: the first step's gradient}, 'start' and 'params'
    {leaf: before and after the steps}}."""
    net.train()
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lr, **(adam or {}))
    losses, first = [], None
    for b in batches:
        loss = cross_entropy(net(b["image"]), b["label"])
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if first is None:
            first = grads
        opt.step(grads)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first, "start": start,
            "params": {k: p.detach().clone() for k, p in params.items()}}
