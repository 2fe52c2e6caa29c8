"""Connected components by min-label propagation (port of
`autoposeestimation_tpu/ops/cca.py`). Every function takes masks (..., H, W)
with any leading batch dimensions and returns per-mask results.

Each masked pixel starts with its flat index; a sweep takes the min over the
8(4)-neighbourhood, then runs segmented running minima along rows and
columns in both directions, so a label crosses a whole straight run in one
sweep. The final label of a component is the minimum flat index of its
pixels (cv2's raster order of components).

The JAX version's `associative_scan` becomes one `torch.cummin` over an
int64 key: `(L + 1 - segment) * BIG + label`, with `segment` the running
count of boundary (background) pixels along the axis. Later segments carry
strictly smaller offsets, so the running minimum never crosses a boundary.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _segmented_cummin(values: torch.Tensor, boundary: torch.Tensor,
                      big: int, dim: int, reverse: bool) -> torch.Tensor:
    """Running min along `dim` that restarts at every boundary element;
    `values` < `big`."""
    if reverse:
        values, boundary = values.flip(dim), boundary.flip(dim)
    offset = (values.shape[dim] + 1
              - torch.cumsum(boundary.to(torch.int64), dim)) * big
    out = torch.cummin(offset + values, dim).values - offset
    return out.flip(dim) if reverse else out


def _window_min(lbl: torch.Tensor, kernel) -> torch.Tensor:
    """Min over a stride-1 'SAME' window; the padding never wins. Labels
    are below 2^24, exact in f32."""
    pad = (kernel[0] // 2, kernel[1] // 2)
    x = -lbl.to(torch.float32).reshape((-1, 1) + lbl.shape[-2:])
    y = -F.max_pool2d(x, kernel, 1, pad)
    return y.reshape(lbl.shape).to(torch.int64)


def connected_components(mask: torch.Tensor, connectivity: int = 8,
                         max_iters: int = 64, fixed_sweeps: int = 0,
                         with_flag: bool = False):
    """int64 labels (..., H, W): masked pixels carry the min flat index of
    their component, background pixels H*W.

    `fixed_sweeps` > 0 runs that many sweeps (bounds the number of turns in
    a component's geometry it can follow); 0 sweeps to convergence, at most
    `max_iters`. `with_flag` also returns a bool `converged` (per mask with
    fixed sweeps: no masked pixel has a smaller label in its
    neighbourhood)."""
    h, w = mask.shape[-2:]
    big = h * w
    if big >= 1 << 24:
        raise ValueError(f"mask of {big} pixels exceeds the f32-exact range")
    flat_idx = torch.arange(big, device=mask.device).reshape(h, w)
    init = torch.where(mask, flat_idx, big)
    boundary = ~mask
    kernels = [(3, 3)] if connectivity == 8 else [(3, 1), (1, 3)]

    def neighborhood_min(lbl):
        nmin = _window_min(lbl, kernels[0])
        for k in kernels[1:]:
            nmin = torch.minimum(nmin, _window_min(lbl, k))
        return torch.where(mask, nmin, big)

    def sweep(lbl):
        lbl = neighborhood_min(lbl)
        for dim, reverse in ((-1, False), (-1, True), (-2, False),
                             (-2, True)):
            lbl = torch.where(
                mask, _segmented_cummin(lbl, boundary, big + 1, dim, reverse),
                big)
        return lbl

    lbl = init
    if fixed_sweeps:
        for _ in range(fixed_sweeps):
            lbl = sweep(lbl)
        if with_flag:
            stale = mask & (neighborhood_min(lbl) < lbl)
            return lbl, ~stale.flatten(-2).any(-1)
        return lbl

    changed = True
    for _ in range(max_iters):
        new = sweep(lbl)
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break
    if with_flag:
        return lbl, torch.tensor(not changed, device=mask.device)
    return lbl


def component_stats(labels: torch.Tensor, mask: torch.Tensor,
                    score: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Per-root-label (counts, score sums), each (..., H*W + 1) indexed by
    root flat index; background falls into the last slot. `weights`
    replaces the per-pixel count of 1 (pooled CCA: per-cell pixel counts,
    with `score` already the per-cell sum)."""
    h, w = labels.shape[-2:]
    n = h * w
    lead = labels.shape[:-2]
    nb = math.prod(lead)
    seg = torch.where(mask, labels, n).reshape(nb, n)
    seg = (seg + torch.arange(nb, device=seg.device)[:, None] * (n + 1))
    valid = mask.reshape(nb, n).to(torch.float32)
    ones = valid if weights is None else (
        weights.reshape(nb, n).to(torch.float32) * valid)
    vals = score.reshape(nb, n).to(torch.float32) * valid
    counts = torch.zeros(nb * (n + 1), device=seg.device).index_add_(
        0, seg.reshape(-1), ones.reshape(-1))
    sums = torch.zeros(nb * (n + 1), device=seg.device).index_add_(
        0, seg.reshape(-1), vals.reshape(-1))
    return counts.reshape(lead + (n + 1,)), sums.reshape(lead + (n + 1,))


def _select_component(labels, mask, counts, sums, min_size: float, rule: str):
    eligible = counts > min_size
    if rule == "mean":
        values = torch.floor(sums / torch.clamp(counts, min=1.0))
    elif rule == "mean_float":
        values = sums / torch.clamp(counts, min=1.0)
    elif rule == "area":
        values = counts
    elif rule == "sum":
        values = sums
    else:
        raise ValueError(f"unknown rule {rule!r}")
    values = torch.where(eligible, values, -math.inf)
    best = torch.argmax(values, dim=-1)  # first max == lowest root label
    found = eligible.any(-1) & (values.amax(-1) > 0)
    comp = mask & (labels == best[..., None, None]) & found[..., None, None]
    return comp, found


def best_component_mask(mask: torch.Tensor, score: torch.Tensor,
                        min_size: float = 0.0, rule: str = "mean",
                        connectivity: int = 8, max_iters: int = 64,
                        scale: int = 1, fixed_sweeps: int = 0,
                        with_flag: bool = False):
    """The best connected component of `mask` by `rule` over `score`:
    'mean' (floored mean score), 'mean_float', 'area' or 'sum', among
    components larger than `min_size`. Returns (component mask, found[,
    converged]); `found` False gives an empty mask.

    `scale` > 1 labels a `scale`-x OR-pooled mask and selects on per-cell
    pixel counts and score sums (the full-resolution statistics), then
    intersects the upsampled winner with the mask; components closer than
    `scale` pixels may merge."""
    if scale <= 1:
        cc = connected_components(mask, connectivity, max_iters,
                                  fixed_sweeps, with_flag)
        labels, converged = cc if with_flag else (cc, None)
        counts, sums = component_stats(labels, mask, score)
        comp, found = _select_component(labels, mask, counts, sums, min_size,
                                        rule)
        return (comp, found, converged) if with_flag else (comp, found)

    h, w = mask.shape[-2:]
    ph, pw = (-h) % scale, (-w) % scale
    m = F.pad(mask.to(torch.float32), (0, pw, 0, ph))
    s = F.pad(torch.where(mask, score, 0.0).to(torch.float32),
              (0, pw, 0, ph))
    cells = m.shape[:-2] + ((h + ph) // scale, scale, (w + pw) // scale,
                            scale)
    cell_cnt = m.reshape(cells).sum((-3, -1))
    cell_sum = s.reshape(cells).sum((-3, -1))
    small_mask = cell_cnt > 0
    cc = connected_components(small_mask, connectivity, max_iters,
                              fixed_sweeps, with_flag)
    labels, converged = cc if with_flag else (cc, None)
    counts, sums = component_stats(labels, small_mask, cell_sum,
                                   weights=cell_cnt)
    comp_small, found = _select_component(labels, small_mask, counts, sums,
                                          min_size, rule)
    comp = comp_small.repeat_interleave(scale, -2).repeat_interleave(
        scale, -1)[..., :h, :w] & mask
    return (comp, found, converged) if with_flag else (comp, found)
