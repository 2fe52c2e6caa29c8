"""Network weights from the seed, made on the device in one draw.

Every convolution and dense weight is a LeCun normal truncated at two
standard deviations (flax's default kernel init, as the measured package
initializes its networks), biases are zero, BatchNorm scales one and its
statistics (0, 1), PReLU slopes 0.25. Two output layers are scaled to
the sizes a trained network gives: the PoseNet's translation head by 0.05,
so that a point's offset to the object is centimetres and not metres, and
the refiner's last layers start at the identity correction (their bias)
plus a hundredth of the draw, so that a pass moves the pose by
centimetres."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from reference import nets as R


def _weight_leaves(module: nn.Module):
    for name, m in module.named_modules():
        if isinstance(m, (R.Conv2d, R.Linear)):
            yield name, m


def make_state(module: nn.Module, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """A state dict for `module` (a reference network; its own values are
    not read, so it may live on the meta device)."""
    state = {k: None for k in module.state_dict()}
    leaves = list(_weight_leaves(module))
    sizes = [m.weight.numel() for _, m in leaves]
    draw = torch.randn(sum(sizes), generator=generator, device=device)
    draw.clamp_(-2.0, 2.0)
    offset = 0
    for (name, m), size in zip(leaves, sizes):
        shape = m.weight.shape
        std = math.sqrt(1.0 / R.fan_in(shape)) / 0.87962566103423978
        w = draw[offset:offset + size].view(shape) * std
        offset += size
        prefix = f"{name}." if name else ""
        is_last = isinstance(module, R.PoseRefineNet) and name.endswith(
            "conv3")
        if is_last:
            w = w * 0.01
        elif name == "head_t.conv4":
            w = w * 0.05
        state[prefix + "weight"] = w
        if m.bias is not None:
            bias = torch.zeros(shape[0], device=device)
            if is_last and name.startswith("head_r"):
                bias.view(-1, 4)[:, 0] = 1.0
            state[prefix + "bias"] = bias
    for name, m in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, R.BatchNorm2d):
            c = m.weight.shape[0]
            state[prefix + "weight"] = torch.ones(c, device=device)
            state[prefix + "bias"] = torch.zeros(c, device=device)
            state[prefix + "running_mean"] = torch.zeros(c, device=device)
            state[prefix + "running_var"] = torch.ones(c, device=device)
        elif isinstance(m, R.PReLU):
            state[prefix + "weight"] = torch.full((1,), 0.25, device=device)
    missing = [k for k, v in state.items() if v is None]
    if missing:
        raise KeyError(f"no rule for {missing[:5]}")
    return state


def reference_nets(cfg: Dict, device) -> Dict[str, nn.Module]:
    """The configuration's three reference networks on `device`."""
    k = cfg["num_objects"]
    with torch.device(device):
        return {"unet": R.UNet(k + 1), "posenet": R.PoseNet(
                    k, cfg["emb_stride"]), "refiner": R.PoseRefineNet(k)}


def seeded_states(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """The three networks' states for `seed`, in a fixed order of draws."""
    shapes = reference_nets(cfg, "meta")
    g = torch.Generator(device=device).manual_seed(seed)
    return {name: make_state(net, g, device) for name, net in shapes.items()}
