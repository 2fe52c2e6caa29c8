"""FLOP counts (`utils/flops.py`) and the timing utilities
(`utils/timing.py`), port against the JAX package on the CPU.

  * The hand kernels' closed forms equal the JAX package's CPU count
    (XLA's cost analysis) of the XLA path of the same function:
    `sym_moments(use_pallas=False)` forward and backward at four shapes,
    `nn_xla` at two.
  * A count is the same whether the kernels' dispatch runs a kernel (a
    stand-in that, like a `ctypes` kernel, does nothing the counter sees)
    or the plain version.
  * The serving graphs and the training step against the JAX package's
    compiled graphs at a small size (2 classes, 64 points, crop 64,
    96x128; B=2, N=64, M=32): the convolution-bound graphs within 5 %.
    The train stages and serving prefixes are held the same way in
    `test_torch_stage_builders.py`.
  * `cached_flops` keys its file by name and config; `StageTimer`'s keys,
    `JsonCurveLog.set` and `maybe_profile`'s trace, which carries the
    program's spans.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu.ops import pallas_addloss as jpa
from autoposeestimation_tpu.utils import flops as jflops
from autoposeestimation_tpu.utils import timing as jtiming
from autoposeestimation_tpu_torch.models import losses
from autoposeestimation_tpu_torch.ops import addloss, knn
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.utils import flops, timing
from autoposeestimation_tpu_torch.utils.io import Intrinsics
from test_torch_seg_models import two_threads  # noqa: F401  (a fixture)
from test_torch_stage_builders import default_precision, fast_init, flops_of

SMALL_SERVING = dict(num_classes=2, num_points=64, crop=64, h=96, w=128,
                     refine_iters=1)
SMALL_TRAIN = dict(batch=2, n=64, m=32, crop=64, num_obj=2)
# the serving graphs and the training step are convolution-bound
FLOP_RTOL = 0.05


def xla_flops(fn, *args) -> float:
    """The JAX package's count of `fn` (its compiled graph's cost
    analysis, at JAX's default matmul precision as the package counts)."""
    with default_precision():
        return flops_of(jax.jit(fn).lower(*args).compile())


def sym_inputs(b, n, m, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(b, n, 4), (b, n, 3), (b, n, 3), (b, m, 3), (b, m, 3)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# M where XLA reduces the minimum in pairs (see addloss.moments_flops)
@pytest.mark.parametrize("b,n,m", [(1, 16, 8), (2, 40, 16), (3, 24, 32),
                                   (1, 40, 64)])
def test_sym_moments_flops_equal_jax_xla_count(b, n, m):
    args = [jnp.asarray(a) for a in sym_inputs(b, n, m)]
    f = jax.vmap(lambda q, t, p, mp, tg: jpa.sym_moments(q, t, p, mp, tg,
                                                         False))
    fwd = xla_flops(f, *args)

    def vjp(q, t, p, mp, tg, gd, gs):
        _, pull = jax.vjp(lambda q, t, p: f(q, t, p, mp, tg), q, t, p)
        return pull((gd, gs))

    ones = jnp.ones((b, n), jnp.float32)
    both = xla_flops(vjp, *args, ones, ones)
    assert addloss.moments_flops(b, n, m) == fwd
    assert addloss.moments_grad_flops(b, n, m) == both - fwd


@pytest.mark.parametrize("m,masked", [(64, True), (256, False)])
def test_nn_flops_equal_jax_xla_count(m, masked):
    """XLA counts one 2,048-query block of `nn_xla`: equal at N=2048."""
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.normal(size=(2048, 3)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(m, 3)), jnp.float32)
    valid = jnp.ones(m, bool)
    fn = ((lambda q, r, v: jknn.nn_xla(q, r, v)) if masked
          else (lambda q, r, v: jknn.nn_xla(q, r)))
    assert knn.nn_flops(2048, m, masked) == xla_flops(fn, q, r, valid)


def loss_inputs(seed=3, b=2, n=24, m=16):
    q, t, p, mp, tg = (torch.from_numpy(a) for a in sym_inputs(b, n, m, seed))
    conf = torch.sigmoid(torch.from_numpy(
        np.random.default_rng(seed + 1).normal(size=(b, n, 1)).astype(
            np.float32)))
    return q, t, conf, tg, mp, p, torch.tensor([True, False])


class Recorded:
    """Kernel stand-ins: the plain versions' outputs, recorded outside
    the count and handed back in the same order, so that inside the count
    the call does nothing the counter sees (as a `ctypes` kernel)."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.outs = {"moments_plain": [], "moments_train_plain": []}

    def record(self):
        for name, outs in self.outs.items():
            plain = getattr(addloss, name)

            def rec(*args, plain=plain, outs=outs):
                out = plain(*args)
                outs.append(out)
                return out

            self.monkeypatch.setattr(addloss, name, rec)

    def replay(self):
        for name, outs in self.outs.items():
            self.monkeypatch.setattr(addloss, name,
                                     lambda *args, outs=outs: outs.pop(0))


def pose_loss_fwd_bwd(sym_bf16=False, with_sym=True):
    """A training step's loss and its backward, then an evaluation's."""
    q, t, c, tg, mp, p, sym = loss_inputs()
    q.requires_grad_()
    t.requires_grad_()
    out = losses.pose_loss(q, t, c, tg, mp, p, sym, with_sym=with_sym,
                           sym_bf16=sym_bf16)
    out.loss.backward()
    with torch.no_grad():
        losses.pose_loss(q, t, c, tg, mp, p, sym, with_sym=with_sym)
    return float(out.loss.detach())


@pytest.mark.parametrize("sym_bf16", [False, True])
def test_count_same_through_kernel_and_plain_dispatch(monkeypatch, sym_bf16):
    """A training step's loss (the training kernel and its backward) and
    an evaluation's (the forward kernel): the count through stand-in
    kernels equals the count through the plain versions, and the kernels'
    share is their closed forms."""
    with flops.counting() as plain:
        want = pose_loss_fwd_bwd(sym_bf16)
    rec = Recorded(monkeypatch)
    rec.record()
    pose_loss_fwd_bwd(sym_bf16)
    rec.replay()
    with flops.counting() as kernel:
        got = pose_loss_fwd_bwd(sym_bf16)
    assert got == want
    assert not any(rec.outs.values())
    b, n, m = 2, 24, 16
    share = (2 * addloss.moments_flops(b, n, m)
             + addloss.moments_grad_flops(b, n, m))
    assert plain.kernels == kernel.kernels == share
    assert plain.total == kernel.total
    # the plain versions' own matmuls are not counted on top: beside the
    # kernels' share the count is that of the loss without them
    with flops.counting() as rest:
        pose_loss_fwd_bwd(sym_bf16, with_sym=False)
    assert rest.kernels == 0 and rest.total > 0
    assert plain.total == rest.total + share


def test_nn_count_same_through_kernel_and_plain(monkeypatch):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(200) > 0.2)
    with flops.counting() as plain:
        want = knn.nn(q, r, valid)
    monkeypatch.setattr(knn, "nn_plain", lambda *a: want)
    with flops.counting() as kernel:
        knn.nn(q, r, valid)
    assert plain.total == kernel.total == knn.nn_flops(300, 200, True)


def test_graph_configs_are_the_jax_packages():
    assert flops.GRAPH_CONFIGS == jflops.GRAPH_CONFIGS


def jax_count(monkeypatch, name, cfg):
    monkeypatch.setitem(jflops.GRAPH_CONFIGS, name, cfg)
    with monkeypatch.context() as m:
        m.setattr(nn.Module, "init", fast_init(5))
        run, args, _ = jflops._GRAPHS[name]()
    return xla_flops(run, *args)


@pytest.mark.parametrize("name", ["serving_graph", "serving_graph_exact",
                                  "serving_graph_u4",
                                  "densefusion_train_step"])
def test_graph_flops_match_jax(monkeypatch, name):
    small = SMALL_TRAIN if name == "densefusion_train_step" else SMALL_SERVING
    cfg = {**jflops.GRAPH_CONFIGS[name], **small}
    want = jax_count(monkeypatch, name, cfg)
    monkeypatch.setitem(flops.GRAPH_CONFIGS, name, cfg)
    got = flops.count_flops(name, "cpu")
    assert abs(got / want - 1) <= FLOP_RTOL, (name, got, want)


def test_cached_flops_keys_by_name_and_config(monkeypatch, tmp_path):
    name = "train_stage_symloss_fwd"
    cfg = dict(num_obj=2, bs=2, n=16, m=8, crop=32, stage="symloss_fwd")
    monkeypatch.setitem(flops.GRAPH_CONFIGS, name, cfg)
    cache = str(tmp_path / "flops.json")
    first = flops.cached_flops(name, "cpu", cache=cache)
    assert first == flops.count_flops(name, "cpu")
    key = name + ":" + json.dumps(cfg, sort_keys=True)
    assert json.load(open(cache)) == {key: first}
    monkeypatch.setattr(flops, "count_flops", None)   # read, not counted
    assert flops.cached_flops(name, "cpu", cache=cache) == first
    assert flops.CACHE.endswith(os.path.join("build", "flops",
                                             "flops_cache.json"))


def test_stage_timer_keys_are_the_jax_ones():
    timers = []
    for mod in (timing, jtiming):
        t = mod.StageTimer()
        with t.stage("segmentation"):
            pass
        with t.stage("pose_estimation"):
            pass
        timers.append(t.total())
    assert list(timers[0]) == list(timers[1]) == [
        "segmentation", "pose_estimation", "total"]
    assert all(v >= 0 for v in timers[0].values())


def test_full_prediction_times_its_stages(two_threads):  # noqa: F811
    mp = np.zeros((1, 10, 3), np.float32)
    models = predict.build_models(1, mp, ("ball",), num_points=16, crop=32,
                                  dtype=torch.float32, device="cpu")
    meta = {"intr": Intrinsics(width=64, height=48, ppx=32, ppy=24, fx=60,
                               fy=60), "depth_scale": 0.001}
    out = predict.full_prediction(np.zeros((48, 64, 3), np.uint8),
                                  np.full((48, 64), 500.0), meta, models,
                                  generator=torch.Generator().manual_seed(0))
    times = out["elapsed_times"]
    assert list(times) == ["segmentation", "pose_estimation", "total"]
    assert times["total"] >= times["segmentation"] + times["pose_estimation"]


def test_curve_log_set_writes_what_the_jax_one_writes(tmp_path):
    logs = []
    for i, mod in enumerate((timing, jtiming)):
        path = str(tmp_path / str(i) / "logs.json")
        log = mod.JsonCurveLog(path, {"lr": 0.1})
        log.append(loss=np.float32(0.5))
        log.set(best_epoch=3, lr=0.01)
        logs.append(open(path).read())
    assert logs[0] == logs[1]


def test_maybe_profile_writes_a_trace(tmp_path, two_threads):  # noqa: F811
    with timing.maybe_profile(None):
        pass
    assert not os.path.exists(tmp_path / "trace")
    mp = np.zeros((1, 10, 3), np.float32)
    models = predict.build_models(1, mp, ("ball",), num_points=16, crop=32,
                                  dtype=torch.float32, device="cpu")
    meta = {"intr": Intrinsics(width=64, height=48, ppx=32, ppy=24, fx=60,
                               fy=60), "depth_scale": 0.001}
    with timing.maybe_profile(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
        predict.full_prediction(np.zeros((48, 64, 3), np.uint8),
                                np.full((48, 64), 500.0), meta, models,
                                generator=torch.Generator().manual_seed(0))
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert "graph.segment" in names      # the program's spans
