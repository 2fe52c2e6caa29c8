"""The port's tracer (`utils/timing.py`: `span`, `count`, `records`) on the
CPU, in the three entries the benchmark drives: `full_prediction`,
`serve_stream` and the DenseFusion training steps.

  * Off, `span` returns one shared object that reads no clock (the clock
    raises here) and records nothing, and the entries' outputs are bit for
    bit those with tracing on.
  * On, each entry's spans nest under its unit ('frame', 'stream.dispatch',
    'step') with one unit id; `full_prediction` counts 5 'host_syncs'. The
    segmentation step records the training steps' three spans too.
  * `serve_stream` closes every span before each `yield`.
  * Under `torch.profiler` each span is an event of the profiler, and
    `Records.epoch_ns` puts its start within 1 ms of the event's.
  * `StageTimer.stage(key, span=...)` opens the span; the buffer is bounded
    and counts what it drops.
"""
import numpy as np
import pytest
import torch

from autoposeestimation_tpu_torch.models.unet import UNet
from autoposeestimation_tpu_torch.parallel.trainers import pose_batches
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.train import segmentation as seg
from autoposeestimation_tpu_torch.utils import timing
from autoposeestimation_tpu_torch.utils.io import Intrinsics

H, W = 48, 64
GRAPH = ["graph.segment", "graph.cca", "graph.crop", "graph.pose",
         "graph.refine"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    timing.disable()
    timing.reset()
    yield
    timing.disable()
    timing.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    mp = np.random.default_rng(0).normal(size=(2, 10, 3)).astype(
        np.float32) * 0.05
    return predict.build_models(2, mp, ("ball", "cube"), num_points=16,
                                crop=32, dtype=torch.float32, device="cpu")


META = {"intr": Intrinsics(width=W, height=H, ppx=32, ppy=24, fx=60, fy=60),
        "depth_scale": 0.001}


def _frame(i):
    rng = np.random.default_rng(i)
    return (rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
            np.full((H, W), 500.0) + rng.normal(size=(H, W)), META)


def _draws(i):
    return np.random.default_rng(100 + i).random((2, 16), dtype=np.float32)


def _frame_entry(models):
    image, depth, meta = _frame(0)
    out = predict.full_prediction(image, depth, meta, models,
                                  uniforms=_draws(0))
    return [out["predictions"], out["cca_converged"]]


def _stream_entry(models):
    return list(predict.serve_stream((_frame(i) for i in range(3)), models,
                                     in_flight=1,
                                     uniforms=(_draws(i) for i in range(3)),
                                     batch=2))


def _step_entry(_models):
    state = dft.create_trainer(2, dft.DFConfig(num_points=16,
                                               num_points_mesh=8),
                               dtype=torch.float32, seed=0, device="cpu")
    batch = dft.to_device(pose_batches(2, 16, 8, 32, 1)[0], "cpu")
    gen = torch.Generator().manual_seed(0)
    loss = dft.estimator_step(state.posenet, state.optimizer, batch,
                              state.w, generator=gen)["loss"]
    dis = dft.refiner_step(state.posenet, state.refiner,
                           dft.make_optimizer(state.refiner.parameters(),
                                              1e-4), batch, state.w)["dis"]
    return [loss, dis, {k: v.clone() for k, v in
                        state.posenet.state_dict().items()}]


ENTRIES = {"frame": _frame_entry, "stream": _stream_entry,
           "step": _step_entry}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _no_clock():
    raise AssertionError("the clock was read with tracing off")


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_off_records_nothing_reads_no_clock_and_keeps_outputs(
        entry, models, monkeypatch):
    monkeypatch.setattr(timing, "_now", _no_clock)
    off = ENTRIES[entry](models)
    rec = timing.records()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0
    monkeypatch.undo()
    timing.enable()
    on = ENTRIES[entry](models)
    assert timing.records().spans
    assert _equal(off, on)


def test_off_span_is_one_shared_no_op():
    a = timing.span("a")
    b = timing.span("b", unit=True, frames=2)
    assert a is b and a.unit is None
    with a as s:
        timing.count("host_syncs")
    assert s is a
    assert timing.records().spans == []


def test_frame_nests_its_spans_under_one_unit(models):
    timing.enable()
    _frame_entry(models)
    rec = timing.records()
    spans = _by_name(rec)
    (frame,) = spans["frame"]
    assert frame.parent is None
    assert {s.unit for s in rec.spans} == {frame.unit}
    ids = {s.id: s for s in rec.spans}
    (compute,) = spans["frame.compute"]
    (readback,) = spans["frame.readback"]
    assert compute.parent == frame.id and readback.parent == frame.id
    for name in ["frame.upload", "frame.wait"] + GRAPH:
        (s,) = spans[name]
        assert s.parent == compute.id, name
        assert compute.start_ns <= s.start_ns <= s.end_ns <= compute.end_ns
    assert all(ids[s.parent].start_ns <= s.start_ns for s in rec.spans
               if s.parent is not None)


def test_full_prediction_counts_five_host_syncs(models):
    timing.enable()
    _frame_entry(models)
    _frame_entry(models)
    rec = timing.records()
    assert rec.counters == {"host_syncs": 10}
    units = [s.unit for s in rec.spans if s.name == "frame"]
    assert rec.counts["host_syncs"] == {u: 5 for u in units}


def test_serve_stream_closes_its_spans_before_each_yield(models):
    timing.enable()
    stacks, yields = [], []
    for _ in predict.serve_stream((_frame(i) for i in range(3)), models,
                                  in_flight=1,
                                  uniforms=(_draws(i) for i in range(3)),
                                  batch=2):
        stacks.append(len(timing._TRACER.stack()))
        yields.append(timing._now())
    assert stacks == [0, 0, 0]
    rec = timing.records()
    assert all(not s.start_ns < t < s.end_ns for s in rec.spans
               for t in yields)
    spans = _by_name(rec)
    calls = spans["stream.dispatch"]
    assert [c.attrs["frames"] for c in calls] == [2, 1]
    assert [c.attrs["batch"] for c in calls] == [2, 2]
    assert [c.unit for c in calls] == sorted({c.unit for c in calls})
    for name in ["stream.upload"] + GRAPH:
        assert sorted(s.unit for s in spans[name]) == [c.unit for c in calls]
        assert {s.parent for s in spans[name]} == {c.id for c in calls}
    assert sorted(s.unit for s in spans["stream.wait"]) == [
        c.unit for c in calls]
    assert sorted(s.unit for s in spans["stream.readback"]) == [
        calls[0].unit, calls[0].unit, calls[1].unit]


def test_training_steps_record_forward_backward_optimizer(models):
    timing.enable()
    _step_entry(models)
    rec = timing.records()
    spans = _by_name(rec)
    steps = spans["step"]
    assert [s.attrs["kind"] for s in steps] == ["estimator", "refiner"]
    for step in steps:
        inside = [s for s in rec.spans if s.unit == step.unit]
        kids = {s.name: s for s in inside if s.parent == step.id}
        assert set(kids) == {"step.forward", "step.backward",
                             "step.optimizer"}
        opt = kids["step.optimizer"]
        assert sorted(s.name for s in inside if s.parent == opt.id) == [
            "optimizer.adam", "optimizer.clip"]
        assert (kids["step.forward"].end_ns <= kids["step.backward"].start_ns
                and kids["step.backward"].end_ns <= opt.start_ns)
    assert rec.counters == {}


def test_segmentation_step_records_forward_backward_optimizer():
    net = UNet(3, decoder_channels=(16, 8, 8, 8, 8),
               encoder_stages=(1, 1, 1, 1))
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(2, 3, 32, 32, generator=g),
             "label": torch.randint(0, 3, (2, 32, 32), generator=g)}
    timing.enable()
    seg.train_step(net, opt, batch, 3)
    rec = timing.records()
    (step,) = _by_name(rec)["step"]
    assert step.attrs == {"kind": "unet"}
    assert all(s.unit == step.unit for s in rec.spans)
    kids = [s for s in rec.spans if s.parent == step.id]
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
        "step.forward", "step.backward", "step.optimizer"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert rec.counters == {}


def test_spans_lie_on_the_profilers_clock(models):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame_entry(models)
    rec = timing.records()
    assert {s.name for s in rec.spans} >= {"frame", "frame.readback", *GRAPH}
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range.start)
    for s in rec.spans:
        assert s.name in events, s.name
        start_us = (rec.epoch_ns(s.start_ns) - t0) * 1e-3
        assert min(abs(start_us - t) for t in events[s.name]) < 1000, s.name


def test_stage_timer_opens_its_span():
    timing.enable()
    timer = timing.StageTimer()
    with timer.stage("segmentation", span="frame.compute"):
        with timing.span("graph.segment"):
            pass
    with timer.stage("pose_estimation"):
        pass
    times = timer.total()
    assert list(times) == ["segmentation", "pose_estimation", "total"]
    spans = _by_name(timing.records())
    assert set(spans) == {"frame.compute", "graph.segment"}
    assert spans["graph.segment"][0].parent == spans["frame.compute"][0].id


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing, "CAPACITY", 4)
    timing.reset()
    timing.enable()
    for i in range(6):
        with timing.span(f"s{i}"):
            timing.count("host_syncs")
    rec = timing.records()
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4", "s5"]
    assert rec.dropped == 2 and rec.counters == {"host_syncs": 6}
    assert len({s.unit for s in rec.spans}) == 4     # each root its own


@pytest.mark.cuda
def test_traced_serve_stream_adds_no_host_sync():
    """`serve_stream` on the card with tracing on, under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on any call
    that makes the host wait for the stream: the spans and the counter add
    none, and each call counts its one event wait and its one replay of
    the frame graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the host-sync check is CUDA's")
    mp = np.random.default_rng(0).normal(size=(2, 10, 3)).astype(
        np.float32) * 0.05
    models = predict.build_models(2, mp, ("ball", "cube"), num_points=16,
                                  crop=32, dtype=torch.float32,
                                  device="cuda")
    frames = [_frame(i) for i in range(3)]
    draws = [_draws(i) for i in range(3)]
    list(predict.serve_stream(frames, models, in_flight=1, uniforms=draws,
                              batch=2))                 # builds and warms up
    torch.cuda.synchronize()
    timing.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = list(predict.serve_stream(frames, models, in_flight=1,
                                         uniforms=draws, batch=2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(outs) == 3
    rec = timing.records()
    assert rec.counters == {"host_syncs": 2, "graph_replays": 2}
    assert len([s for s in rec.spans if s.name == "stream.dispatch"]) == 2
