"""A SegNet training step: the reference's forward over a batch, the
cross-entropy over every pixel and the backward (the first convolution
computes no input gradient: the images need none)."""
import torch

from counts import rules
from reference import segnet as S


def at(cfg, traffic):
    return {"batch_size": cfg["batch_size"], "image_hw": cfg["image_hw"]}


def flops(cfg, traffic):
    b, (h, w) = cfg["batch_size"], cfg["image_hw"]
    with torch.device("meta"):
        net = S.SegNet(cfg["classes"])
        image = torch.empty(b, 3, h, w)
        label = torch.zeros(b, h, w, dtype=torch.int64)
        with rules.counting() as mode:
            S.cross_entropy(net(image), label).backward()
    return int(mode.get_total_flops())
