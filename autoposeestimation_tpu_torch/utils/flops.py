"""Per-graph FLOP counts (port of `autoposeestimation_tpu/utils/flops.py`).

`count_flops(name, device)` builds the named graph of `GRAPH_CONFIGS` (the
JAX package's names and shapes) on `device` and runs it once under
`torch.utils.flop_counter.FlopCounterMode`, which counts the matmuls and
convolutions from their shapes, forward and backward; a convolution counts
the taps that land inside its input, as XLA's cost analysis counts it
(FlopCounterMode's own formula counts the taps on the zero padding too,
2 % more at the full-size PSPNet and 17 % more at a 64-pixel crop). The
count depends on the shapes only, so it is taken on the device that runs
the graph.
`cached_flops(name, device)` keeps the counts in a JSON file keyed by the
name and the config (`build/flops/flops_cache.json` under the checkout,
which git ignores).

The hand kernels are reached through `ctypes`, where the counter sees
nothing. Their calls go through `hand_kernel` (at the dispatch of
`ops/addloss.py::moments` / `moments_train` and `ops/knn.py::nn`), which
adds a closed form of their work from the shapes and takes back out what
the counter saw inside the call, the plain version's own matmuls: the
count is the same whichever implementation runs. The closed forms are the
JAX package's CPU count (XLA's cost analysis) of the XLA path of the same
function: `sym_moments(use_pallas=False)` forward
(`ops/addloss.py::moments_flops`) and its backward
(`moments_grad_flops`, added by `SymMoments.backward`), and `nn_xla`
(`ops/knn.py::nn_flops`). XLA counts elementwise work too, which
FlopCounterMode does not: graphs of convolutions agree with the JAX
package's counts, elementwise ones (the CCA, the projections, the losses)
count less here.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(_REPO, "build", "flops", "flops_cache.json")

PREFIXES = ("seg", "seg_cca", "perclass", "estimator", "full")
TRAIN_STAGES = ("pspnet_fwd", "posenet_fwd", "symloss_fwd",
                "symloss_fwd_bwd", "estimator_step",
                "estimator_step_symbf16", "refiner_step")

# The benchmarked graphs: names and shapes as in the JAX package.
GRAPH_CONFIGS = {
    "serving_graph": dict(num_classes=5, num_points=1000, crop=320, h=480,
                          w=640, refine_iters=2, emb_stride=8),
    "serving_graph_exact": dict(num_classes=5, num_points=1000, crop=320,
                                h=480, w=640, refine_iters=2, emb_stride=1),
    "serving_graph_s2": dict(num_classes=5, num_points=1000, crop=320,
                             h=480, w=640, refine_iters=2, emb_stride=2),
    "serving_graph_u4": dict(num_classes=5, num_points=1000, crop=320,
                             h=480, w=640, refine_iters=2, emb_stride=8,
                             seg_out_stride=4),
    "serving_graph_s2_u4": dict(num_classes=5, num_points=1000, crop=320,
                                h=480, w=640, refine_iters=2, emb_stride=2,
                                seg_out_stride=4),
    "densefusion_train_step": dict(batch=8, n=1000, m=500, crop=320,
                                   num_obj=5),
}
for _p in PREFIXES:
    GRAPH_CONFIGS[f"serving_prefix_{_p}"] = dict(
        num_classes=5, num_points=1000, crop=320, h=480, w=640,
        refine_iters=2, emb_stride=8, prefix=_p)
    GRAPH_CONFIGS[f"serving_prefix_{_p}_u4"] = dict(
        num_classes=5, num_points=1000, crop=320, h=480, w=640,
        refine_iters=2, emb_stride=8, seg_out_stride=4, prefix=_p)
for _t in TRAIN_STAGES:
    GRAPH_CONFIGS[f"train_stage_{_t}"] = dict(
        num_obj=5, bs=8, n=1000, m=500, crop=320, stage=_t)


class _Tally:
    def __init__(self, mode) -> None:
        self.mode = mode
        self.kernels = 0   # the hand kernels' closed forms
        self.hidden = 0    # what the counter saw inside their calls


# the open count: process-wide, since the autograd engine runs a CUDA
# backward (and its kernels' share, `add`) on a thread of its own
_open: Optional[_Tally] = None


def hand_kernel(flops: int, fn, *args):
    """`fn(*args)`, a hand kernel or its plain version. Inside `counting`
    the call counts as `flops` whichever implementation runs."""
    tally = _open
    if tally is None:
        return fn(*args)
    before = tally.mode.get_total_flops()
    out = fn(*args)
    tally.hidden += tally.mode.get_total_flops() - before
    tally.kernels += flops
    return out


def add(flops: int) -> None:
    """Count `flops` of work the counter cannot see (a hand kernel's
    share of a backward) inside `counting`."""
    if _open is not None:
        _open.kernels += flops


class Count:
    """The result of a `counting` block: `total`, and `kernels`, the hand
    kernels' share of it."""

    total: int = 0
    kernels: int = 0


def _valid_taps(size: int, kernel: int, stride: int, pad: int,
                dilation: int, out: int) -> int:
    """(output position, kernel tap) pairs of one axis whose input index
    lies inside the input (not in the zero padding)."""
    return sum(1 for o in range(out) for k in range(kernel)
               if 0 <= o * stride + k * dilation - pad < size)


def _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                      out_shape) -> int:
    """2 x the multiply-adds of a convolution whose taps land inside the
    input: XLA's count of a convolution, which leaves out the taps on the
    zero padding."""
    taps = 1
    for d in range(2, len(x_shape)):
        taps *= _valid_taps(x_shape[d], w_shape[d], stride[d - 2],
                            padding[d - 2], dilation[d - 2], out_shape[d])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    if transposed:
        from torch.utils.flop_counter import conv_flop_count

        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                             out_shape)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    """The input's and the weight's gradients each visit the forward's
    (output, tap, input) triples once."""
    if transposed:
        from torch.utils.flop_counter import conv_backward_flop

        return conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias,
                                  stride, padding, dilation, transposed,
                                  _output_padding, _groups, output_mask,
                                  out_shape)
    fwd = _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                            grad_out_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _custom_mapping() -> dict:
    import torch

    aten = torch.ops.aten
    return {aten.convolution: _conv_flop, aten._convolution: _conv_flop,
            aten.convolution_backward: _conv_backward_flop}


@contextlib.contextmanager
def counting():
    """Count the FLOPs of the work in the block, forward and backward:
    FlopCounterMode's count of matmuls and convolutions plus the hand
    kernels' closed forms. Yields a `Count`, filled in at the end."""
    global _open
    from torch.utils.flop_counter import FlopCounterMode

    if _open is not None:
        raise RuntimeError("a FLOP count is already open")
    count = Count()
    mode = FlopCounterMode(display=False, custom_mapping=_custom_mapping())
    with mode:
        _open = _Tally(mode)
        try:
            yield count
        finally:
            tally, _open = _open, None
    count.kernels = tally.kernels
    count.total = mode.get_total_flops() - tally.hidden + tally.kernels


def count_flops(name: str, device=None) -> int:
    """FLOPs of one run of the named graph at its GRAPH_CONFIGS shapes,
    built in bf16 on `device` (cuda by default)."""
    cfg = GRAPH_CONFIGS[name]
    if name.startswith("serving_prefix_"):
        run, args = _build_serving_prefix(cfg, device)
    elif name.startswith("train_stage_"):
        run, args = _build_train_stage(cfg, device)
    elif name.startswith("serving_graph"):
        run, args = _build_serving_graph(cfg, device)
    elif name == "densefusion_train_step":
        run, args = _build_densefusion_train_step(cfg, device)
    else:
        raise KeyError(name)
    with counting() as count:
        run(*args)
    return count.total


def cached_flops(name: str, device=None, cache: Optional[str] = None
                 ) -> int:
    """`count_flops(name, device)` at the graph's GRAPH_CONFIGS shapes,
    from the cache file (`CACHE` by default) or counted and written there.
    The key is the name and the config, so a changed shape is counted
    anew."""
    cache = cache or CACHE
    key = name + ":" + json.dumps(GRAPH_CONFIGS[name], sort_keys=True)
    try:
        with open(cache) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    if key not in table:
        table[key] = count_flops(name, device)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "w") as f:
            json.dump(table, f, indent=1)
    return int(table[key])


def _build_serving_graph(cfg: dict, device):
    """The frame graph (`pipeline/predict.py::_predict_frame`) on a zero
    image and a flat depth of 700 units, as the JAX package counts it."""
    import numpy as np
    import torch

    from ..pipeline import predict

    k = cfg["num_classes"]
    model_points = np.random.default_rng(0).normal(size=(k, 1000, 3)).astype(
        np.float32) * 0.05
    models = predict.build_models(
        k, model_points, tuple(f"obj{i}" for i in range(k)),
        num_points=cfg["num_points"], crop=cfg["crop"],
        refine_iters=cfg["refine_iters"], dtype=torch.bfloat16,
        emb_stride=cfg["emb_stride"],
        seg_out_stride=cfg.get("seg_out_stride", 1), device=device)
    dev = models.device
    image = torch.zeros((cfg["h"], cfg["w"], 3), dtype=torch.uint8,
                        device=dev)
    depth = torch.full((cfg["h"], cfg["w"]), 700.0, device=dev)
    intr = torch.tensor([600.0, 600.0, 320.0, 240.0], device=dev)
    scale = torch.tensor(0.001, device=dev)
    u = torch.rand((k, cfg["num_points"]),
                   generator=torch.Generator().manual_seed(0)).to(dev)

    @torch.inference_mode()
    def run():
        return predict._predict_frame(models, image, depth, intr, scale, u)

    return run, ()


def _build_densefusion_train_step(cfg: dict, device):
    """One estimator step with the symmetric loss (B, N, M, crop of the
    config), its batch drawn as the JAX package draws it."""
    import numpy as np
    import torch

    from ..train import densefusion as dft

    dcfg = dft.DFConfig(num_points=cfg["n"], num_points_mesh=cfg["m"])
    state = dft.create_trainer(cfg["num_obj"], dcfg, dtype=torch.bfloat16,
                               device=device)
    rng = np.random.default_rng(0)
    b, n, m, crop = cfg["batch"], cfg["n"], cfg["m"], cfg["crop"]
    batch = dft.to_device({
        "img": rng.normal(size=(b, crop, crop, 3)).astype(np.float32),
        "cloud": (rng.normal(size=(b, n, 3)) * 0.05).astype(np.float32),
        "choose": rng.integers(0, crop * crop, (b, n)),
        "target": (rng.normal(size=(b, m, 3)) * 0.05).astype(np.float32),
        "model_points": (rng.normal(size=(b, m, 3)) * 0.05).astype(
            np.float32),
        "obj_idx": rng.integers(0, cfg["num_obj"], b),
        "is_sym": rng.integers(0, 2, b).astype(bool),
    }, state.device)
    gen = torch.Generator(device=state.device).manual_seed(0)

    def run():
        return dft.estimator_step(state.posenet, state.optimizer, batch,
                                  dcfg.w, with_sym=True, sym_bf16=False,
                                  generator=gen)

    return run, ()


def _build_serving_prefix(cfg: dict, device):
    """One cumulative prefix of the frame graph
    (`utils/serving_stages.py`), called once."""
    from . import serving_stages

    cfg = dict(cfg)
    prefix = cfg.pop("prefix")
    steps, models = serving_stages.build_prefixes(**cfg, device=device)
    return steps[prefix], (serving_stages.initial_carry(models.device), 0)


def _build_train_stage(cfg: dict, device):
    """One train stage (`utils/train_stages.py`), called once."""
    from . import train_stages

    cfg = dict(cfg)
    stage = cfg.pop("stage")
    steps, carries = train_stages.build_stages(**cfg, device=device)
    return steps[stage], (carries[stage], 0)
