"""The arithmetic of the metrics: a window's rate, the 95th percentile
over all frames, the idle share, launches and MFU from a
synthetic trace, and a roofline share that cannot pass 100 %."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from counts import bounds
from harness import readers, stats
from harness import trace as tr

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_rate_is_over_the_whole_window():
    assert stats.rate(300, 12.0) == 25.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_over_all_frames():
    xs = list(np.random.default_rng(0).exponential(size=1001))
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    # a median of chunk medians would hide the tail; the percentile sees it
    tail = [1.0] * 90 + [10.0] * 10
    assert stats.percentile(tail, 95) == 10.0



def _trace():
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [ev(mark, 0, 1),
              ev("kernel_a", 100, 300), ev("kernel_b", 250, 400),
              ev("Memcpy HtoD (Pinned -> Device)", 500, 550),
              ev("kernel_a", 900, 1000), ev(mark, 999, 1000)]
    return tr.reduce_device(events)


def test_trace_busy_idle_and_launches():
    t = _trace()
    assert t.window_s == pytest.approx(1000e-6)
    # kernels 100-400, copy 500-550, kernel 900-999 (the end marker's own
    # time is not the program's)
    assert t.busy_s == pytest.approx(450e-6)
    assert t.kernels["kernel_a"] == (2, pytest.approx(300e-6))
    assert t.launches == 3
    # the untraced window ran the same 3 units in the same 1 ms
    ctx = SimpleNamespace(trace=t, traced_units=3,
                          window={"units": 3, "seconds": 1000e-6})
    assert readers.idle_pct(ctx) == pytest.approx(55.0)
    assert readers.launches_per_unit(ctx) == pytest.approx(1.0)
    # untraced, the host launched twice as fast: the device idles less
    ctx.window = {"units": 6, "seconds": 1000e-6}
    assert readers.idle_pct(ctx) == pytest.approx(10.0)


def test_idle_gaps_by_host_op():
    events = [ev(tr.SPAN, 0, 1000, CPU),
              ev("aten::conv2d", 0, 300, CPU),
              ev("cudaStreamSynchronize", 600, 950, CPU),
              ev("kernel_a", 100, 300), ev("kernel_b", 250, 400),
              ev("kernel_a", 900, 1000)]
    names = dict(tr.idle_gaps(events))
    assert names["cudaStreamSynchronize"] == pytest.approx(500e-6)
    assert names["aten::conv2d"] == pytest.approx(100e-6)


def test_device_trace_needs_its_markers():
    with pytest.raises(RuntimeError):
        tr.reduce_device([ev("kernel_a", 0, 10)])


def test_no_device_activity_reads_nothing():
    mark = "spin_kernel"
    t = tr.reduce_device([ev(mark, 0, 1), ev(mark, 999, 1000)])
    ctx = SimpleNamespace(trace=t, traced_units=5,
                          window={"units": 5, "seconds": 1.0})
    assert readers.idle_pct(ctx) is None
    assert readers.launches_per_unit(ctx) is None


def test_mfu_from_frozen_flops():
    ctx = SimpleNamespace(window={"units": 100, "seconds": 4.0})
    got = readers.mfu_pct(ctx, 382e9 * 100)
    assert got == pytest.approx(100 * 382e9 * 25 / 989e12)


def test_roofline_bound_is_the_largest_unit_time():
    s = bounds.sym_moments_train_seconds(8, 1000, 500, "bf16")
    pairs = 8 * 1000 * 500 * 500
    assert s == pytest.approx(pairs / bounds.LANE_OPS)
    assert s > 10 * pairs / bounds.TENSOR_PEAK["bf16"]
    # a kernel at the bound reads 100 %, never more
    from harness.files import Cell, load_module
    cell = Cell("train.autopose_5obj")
    mod = load_module(os.path.join(cell.root, "metrics",
                                   "sym_moments_train.roofline_pct.py"),
                      "roof_test")
    t = SimpleNamespace(kernel=lambda f: (4, 4 * s))
    assert mod.read(SimpleNamespace(trace=t, cell=cell)) == pytest.approx(
        100.0)
    t = SimpleNamespace(kernel=lambda f: (0, 0.0))
    assert mod.read(SimpleNamespace(trace=t, cell=cell)) is None
