"""The weight bridge between the JAX package's flax variable trees (nested
dicts of numpy arrays, as `train/checkpoints.load_checkpoint` returns them)
and the port's state_dicts for `UNet`, `PoseNet`, `PoseRefineNet` and the
segmentation registry's `LinkNet`, `PSPNetSeg` and `SegNet`, both ways:
`to_state_dict` reads a tree, `to_variables` writes one.

Each model has a plan: one (flax path, state_dict key, conversion) entry per
leaf. Conversions: conv kernel HWIO -> OIHW, transposed-conv kernel HWIO ->
(I, O, H, W) flipped in space (flax's `ConvTranspose` does not flip it,
`F.conv_transpose2d` does), dense kernel (I, O) -> (O, I),
PReLU slope () -> (1,), everything else copied (BatchNorm scale/bias ->
weight/bias, batch_stats mean/var -> running_mean/running_var).

The `*_variables(model)` exports read `models/common.py::
full_state_dict`: a layer whose output rows were split over tensor-parallel
ranks is gathered back to its full weight (every rank of its group takes
part), so a flax tree never holds one rank's shard."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .models.common import full_state_dict
from .models.segnet import DECODER_WIDTHS, ENCODER_WIDTHS

Entry = Tuple[Tuple[str, ...], str, str]


def _conv(plan: List[Entry], fp, key: str, bias: bool = False) -> None:
    plan.append((("params",) + fp + ("kernel",), key + ".weight", "conv"))
    if bias:
        plan.append((("params",) + fp + ("bias",), key + ".bias", "copy"))


def _dense(plan: List[Entry], fp, key: str) -> None:
    plan.append((("params",) + fp + ("kernel",), key + ".weight", "dense"))
    plan.append((("params",) + fp + ("bias",), key + ".bias", "copy"))


def _bn(plan: List[Entry], fp, key: str) -> None:
    plan.append((("params",) + fp + ("scale",), key + ".weight", "copy"))
    plan.append((("params",) + fp + ("bias",), key + ".bias", "copy"))
    plan.append((("batch_stats",) + fp + ("mean",), key + ".running_mean",
                 "copy"))
    plan.append((("batch_stats",) + fp + ("var",), key + ".running_var",
                 "copy"))


def _encoder(plan: List[Entry], enc, prefix: str,
             encoder_stages: Sequence[int]) -> None:
    _conv(plan, enc + ("Conv_0",), prefix + "conv1")
    _bn(plan, enc + ("BatchNorm_0",), prefix + "bn1")
    k = 0
    for stage, blocks in enumerate(encoder_stages):
        for b in range(blocks):
            f = enc + (f"BasicBlockBN_{k}",)
            t = f"{prefix}layer{stage + 1}.{b}"
            _conv(plan, f + ("Conv_0",), t + ".conv1")
            _bn(plan, f + ("BatchNorm_0",), t + ".bn1")
            _conv(plan, f + ("Conv_1",), t + ".conv2")
            _bn(plan, f + ("BatchNorm_1",), t + ".bn2")
            if stage > 0 and b == 0:
                _conv(plan, f + ("Conv_2",), t + ".downsample.0")
                _bn(plan, f + ("BatchNorm_2",), t + ".downsample.1")
            k += 1


def unet_plan(encoder_stages: Sequence[int] = (3, 4, 6, 3)) -> List[Entry]:
    """The U-Net's plan; the stem's input width comes from the arrays, so
    a 7-channel U-Net uses it too."""
    plan: List[Entry] = []
    _encoder(plan, ("ResNetEncoder_0",), "encoder.", encoder_stages)
    for i in range(5):
        f = (f"DecoderBlock_{i}",)
        _conv(plan, f + ("Conv_0",), f"decoder.{i}.conv1")
        _bn(plan, f + ("BatchNorm_0",), f"decoder.{i}.bn1")
        _conv(plan, f + ("Conv_1",), f"decoder.{i}.conv2")
        _bn(plan, f + ("BatchNorm_1",), f"decoder.{i}.bn2")
    _conv(plan, ("Conv_0",), "head", bias=True)
    return plan


def linknet_plan(encoder_stages: Sequence[int] = (3, 4, 6, 3)
                 ) -> List[Entry]:
    plan: List[Entry] = []
    _encoder(plan, ("ResNetEncoder_0",), "encoder.", encoder_stages)
    for i in range(4):
        f = (f"LinkNetDecoderBlock_{i}",)
        t = f"decoder.{i}"
        _conv(plan, f + ("Conv_0",), t + ".conv1")
        _bn(plan, f + ("BatchNorm_0",), t + ".bn1")
        plan.append((("params",) + f + ("ConvTranspose_0", "kernel"),
                     t + ".deconv.weight", "convT"))
        _bn(plan, f + ("BatchNorm_1",), t + ".bn2")
        _conv(plan, f + ("Conv_1",), t + ".conv2")
        _bn(plan, f + ("BatchNorm_2",), t + ".bn3")
    _conv(plan, ("Conv_0",), "head", bias=True)
    return plan


def pspnet_seg_plan(encoder_stages: Sequence[int] = (3, 4, 6, 3),
                    n_sizes: int = 4) -> List[Entry]:
    plan: List[Entry] = []
    _encoder(plan, ("ResNetEncoder_0",), "encoder.", encoder_stages)
    for i in range(n_sizes):
        _conv(plan, (f"Conv_{i}",), f"stages.{i}")
    _conv(plan, (f"Conv_{n_sizes}",), "bottleneck")
    _bn(plan, ("BatchNorm_0",), "bn")
    _conv(plan, (f"Conv_{n_sizes + 1}",), "head", bias=True)
    return plan


def segnet_plan() -> List[Entry]:
    plan: List[Entry] = []
    for k, widths in enumerate(ENCODER_WIDTHS + DECODER_WIDTHS):
        part, i = (("encoder", k) if k < len(ENCODER_WIDTHS)
                   else ("decoder", k - len(ENCODER_WIDTHS)))
        for j in range(len(widths)):
            f = (f"_ConvStack_{k}",)
            _conv(plan, f + (f"Conv_{j}",), f"{part}.{i}.convs.{j}")
            _bn(plan, f + (f"BatchNorm_{j}",), f"{part}.{i}.bns.{j}")
    _conv(plan, ("Conv_0",), "head", bias=True)
    return plan


_FEAT = ("conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6")


def posenet_plan() -> List[Entry]:
    plan: List[Entry] = []
    psp = ("PSPNet_0",)
    res = psp + ("DilatedResNetNoBN_0",)
    _conv(plan, res + ("Conv_0",), "cnn.feats.conv1")
    k = 0
    for layer in range(1, 5):
        for b in range(2):
            f = res + (f"BasicBlockPlain_{k}",)
            t = f"cnn.feats.layer{layer}.{b}"
            _conv(plan, f + ("Conv_0",), t + ".conv1")
            _conv(plan, f + ("Conv_1",), t + ".conv2")
            if layer > 1 and b == 0:
                _conv(plan, f + ("Conv_2",), t + ".downsample")
            k += 1
    mod = psp + ("PSPModule_0",)
    for i in range(4):
        _conv(plan, mod + (f"Conv_{i}",), f"cnn.psp.stages.{i}")
    _conv(plan, mod + ("Conv_4",), "cnn.psp.bottleneck", bias=True)
    for i in range(3):
        up = psp + (f"PSPUpsample_{i}",)
        _conv(plan, up + ("Conv_0",), f"cnn.up_{i + 1}.conv", bias=True)
        plan.append((("params",) + up + ("PReLU_0", "negative_slope"),
                     f"cnn.up_{i + 1}.prelu.weight", "prelu"))
    _conv(plan, psp + ("Conv_0",), "cnn.final", bias=True)
    for i, name in enumerate(_FEAT):
        _dense(plan, ("PoseNetFeat_0", f"Dense_{i}"), f"feat.{name}")
    for h, suffix in enumerate("rtc"):
        for i in range(4):
            _dense(plan, (f"PoseHead_{h}", f"Dense_{i}"),
                   f"head_{suffix}.conv{i + 1}")
    return plan


def refiner_plan() -> List[Entry]:
    plan: List[Entry] = []
    for i, name in enumerate(_FEAT):
        _dense(plan, ("PoseRefineNetFeat_0", f"Dense_{i}"), f"feat.{name}")
    for h, suffix in enumerate("rt"):
        for i in range(3):
            _dense(plan, (f"RefineHead_{h}", f"Dense_{i}"),
                   f"head_{suffix}.conv{i + 1}")
    return plan


def _convert(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)
    if kind == "convT":
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "dense":
        return arr.T
    if kind == "prelu":
        return arr.reshape(1)
    return arr


def to_state_dict(variables: Dict[str, Any],
                  plan: List[Entry]) -> Dict[str, torch.Tensor]:
    """Apply `plan` to a flax variable tree; raises KeyError on a missing
    leaf."""
    out: Dict[str, torch.Tensor] = {}
    for path, key, kind in plan:
        node = variables
        for p in path:
            node = node[p]
        arr = _convert(np.asarray(node, np.float32), kind)
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


_INVERSE = {"conv": lambda a: a.transpose(2, 3, 1, 0),
            "convT": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
            "dense": lambda a: a.T,
            "prelu": lambda a: a.reshape(())}


def to_variables(state: Dict[str, torch.Tensor],
                 plan: List[Entry]) -> Dict[str, Any]:
    """The inverse of `to_state_dict`: a state_dict -> the flax variable
    tree (nested dicts of f32 numpy arrays)."""
    tree: Dict[str, Any] = {}
    for path, key, kind in plan:
        arr = state[key].detach().to("cpu", torch.float32).numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        # np.array, not ascontiguousarray: that would make the () slope (1,)
        node[path[-1]] = np.array(_INVERSE.get(kind, lambda a: a)(arr),
                                  order="C")
    return tree


def unet_state_dict(variables):
    return to_state_dict(variables, unet_plan())


def unet_variables(model: torch.nn.Module) -> Dict[str, Any]:
    return to_variables(full_state_dict(model), unet_plan())


def posenet_state_dict(variables):
    return to_state_dict(variables, posenet_plan())


def refiner_state_dict(variables):
    return to_state_dict(variables, refiner_plan())


def posenet_variables(model: torch.nn.Module) -> Dict[str, Any]:
    return to_variables(full_state_dict(model), posenet_plan())


def refiner_variables(model: torch.nn.Module) -> Dict[str, Any]:
    return to_variables(full_state_dict(model), refiner_plan())
