"""SegNet's weights from the seed, drawn by the benchmark and loaded into
both the program and the reference, so that the check does not start from
weights the program made.

Every convolution weight is a LeCun normal truncated at two standard
deviations (flax's default kernel init, which the measured package's
`init_like_flax` follows), drawn on the device in one draw by the inverse
of the normal's distribution function; biases are zero, BatchNorm scales
one and its statistics (0, 1), as `weights.make_state` makes the other
networks'."""
from __future__ import annotations

import math
from typing import Dict

import torch

from reference import segnet as RS

# a unit normal truncated to [-2, 2] has this standard deviation
TRUNCATED_STD = 0.87962566103423978


def seeded_state(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `RS.SegNet(cfg['classes'])` for `seed`."""
    with torch.device("meta"):
        shapes = RS.SegNet(cfg["classes"]).state_dict()
    convs = [k for k, v in shapes.items()
             if k.endswith("weight") and v.dim() == 4]
    sizes = [shapes[k].numel() for k in convs]
    g = torch.Generator(device=device).manual_seed(seed)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(sum(sizes), generator=g, device=device,
                   dtype=torch.float64)
    draw = (math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
            ).clamp_(-2.0, 2.0).to(torch.float32)
    state, offset = {}, 0
    for k, size in zip(convs, sizes):
        shape = shapes[k].shape
        std = math.sqrt(1.0 / (shape[1] * math.prod(shape[2:])))
        state[k] = draw[offset:offset + size].view(shape) * (
            std / TRUNCATED_STD)
        offset += size
    for k, v in shapes.items():
        if k not in state:
            one = (".bns." in k and k.endswith(".weight")
                   or k.endswith(".running_var"))
            state[k] = torch.full(v.shape, 1.0 if one else 0.0,
                                  device=device)
    return state
