"""Staged DenseFusion training batches, drawn on the device from the seed
(the layout and the distributions of the measured package's
`pose_batches`): normalized crops (B, 3, S, S), clouds and model and
target points of 5 cm spread, chosen crop pixels, objects drawn over the
configuration's classes, and a fixed share of symmetric samples in every
batch, so that every batch does the same work."""
from __future__ import annotations

from typing import Dict, List

import torch


def batch_pool(count: int, batch: int, crop: int, n: int, m: int,
               num_obj: int, sym_share: float, seed: int, device
               ) -> List[Dict[str, torch.Tensor]]:
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    n_sym = int(round(sym_share * batch))
    out = []
    for _ in range(count):
        sym = torch.zeros(batch, dtype=torch.bool, device=device)
        sym[torch.randperm(batch, **kw)[:n_sym]] = True
        out.append({
            "img": torch.randn((batch, 3, crop, crop), **kw),
            "cloud": torch.randn((batch, n, 3), **kw) * 0.05,
            "choose": torch.randint(0, crop * crop, (batch, n), **kw),
            "target": torch.randn((batch, m, 3), **kw) * 0.05,
            "model_points": torch.randn((batch, m, 3), **kw) * 0.05,
            "obj_idx": torch.randint(0, num_obj, (batch,), **kw),
            "is_sym": sym})
    return out
