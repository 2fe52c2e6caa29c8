"""The readers of the program's spans and counter (`metrics/*_per_frame.py`,
`metrics/*_per_step.py` through `harness/spans.py`) on fabricated records
of the port's tracer: only the first `traced_units` frames or steps are
read, a stream call's time is divided by its frames, and None comes back
where nothing was recorded or the program has no tracer."""
import os
from types import SimpleNamespace

import pytest

from autoposeestimation_tpu_torch.utils.timing import Records, Span
from harness import files
from harness import spans as S

MS = 1_000_000          # ns


def _reader(name):
    return files.load_module(os.path.join(files.HERE, "metrics",
                                          name + ".py"),
                             "port_bench_metric_" + name)


class Fab:
    """Records built span by span; each unit's spans last `ms` apiece."""

    def __init__(self):
        self.spans, self.counts, self.t, self.next_id = [], {}, 0, 1

    def span(self, name, unit, ms, parent=None, **attrs):
        s = Span(name, self.next_id, parent, unit, self.t, self.t + ms * MS,
                 attrs)
        self.next_id += 1
        self.t += ms * MS
        self.spans.append(s)
        return s

    def count(self, name, unit, n):
        self.counts.setdefault(name, {})[unit] = n

    def records(self):
        totals = {k: sum(v.values()) for k, v in self.counts.items()}
        return Records(self.spans, totals, self.counts, 0, (0, 0))


def live(units=3):
    """Frame u (1-based) spends u ms in each stage."""
    f = Fab()
    for u in range(1, units + 1):
        head = f.span("frame", u, 10 * u)
        for name in ("frame.upload", "graph.segment", "graph.cca",
                     "graph.crop", "graph.pose", "graph.refine",
                     "frame.wait", "frame.readback"):
            f.span(name, u, u, head.id)
        f.count("host_syncs", u, 5)
    return f.records()


def stream(calls=3, batch=4):
    """Call u of `batch` frames spends u ms in each stage and u ms in each
    frame's readback; the last call is short by one frame."""
    f = Fab()
    for u in range(1, calls + 1):
        frames = batch - (u == calls)
        head = f.span("stream.dispatch", u, 10 * u, frames=frames,
                      batch=batch, in_flight=1)
        for name in ("stream.upload", "graph.segment", "graph.cca",
                     "graph.crop", "graph.pose", "graph.refine"):
            f.span(name, u, u, head.id)
        f.span("stream.wait", u, u)
        for _ in range(frames):
            f.span("stream.readback", u, u)
        f.count("host_syncs", u, 1)
    return f.records()


def train(steps=3):
    """Step u spends u ms forward, 2u backward and 3u in the optimizer."""
    f = Fab()
    for u in range(1, steps + 1):
        head = f.span("step", u, 10 * u, kind="estimator")
        f.span("step.forward", u, u, head.id)
        f.span("step.backward", u, 2 * u, head.id)
        opt = f.span("step.optimizer", u, 3 * u, head.id)
        f.span("optimizer.clip", u, u, opt.id)
    return f.records()


# (reader, records, traced units, reading)
CASES = [
    ("dispatch_ms_per_frame", live, 2, 6 * (1 + 2) / 2),
    ("wait_ms_per_frame", live, 2, (1 + 2) / 2),
    ("readback_ms_per_frame", live, 2, (1 + 2) / 2),
    ("host_syncs_per_frame", live, 2, 5.0),
    ("dispatch_ms_per_frame", stream, 8, 6 * (1 + 2) / 8),
    ("wait_ms_per_frame", stream, 8, (1 + 2) / 8),
    ("readback_ms_per_frame", stream, 8, (4 * 1 + 4 * 2) / 8),
    ("host_syncs_per_frame", stream, 8, 2 / 8),
    ("forward_ms_per_step", train, 2, (1 + 2) / 2),
    ("backward_ms_per_step", train, 2, (2 + 4) / 2),
    ("optimizer_ms_per_step", train, 2, (3 + 6) / 2),
]


@pytest.mark.parametrize("name,make,traced,want", CASES,
                         ids=[f"{c[0]}-{c[1].__name__}" for c in CASES])
def test_reads_the_first_traced_units_only(name, make, traced, want,
                                           monkeypatch):
    rec = make()
    monkeypatch.setattr(S, "records", lambda: rec)
    got = _reader(name).read(SimpleNamespace(traced_units=traced))
    assert got == pytest.approx(want, rel=1e-12)


def test_a_stream_call_counts_its_frames(monkeypatch):
    """The first window's 7 frames end inside the second call; the short
    third call is not read. Per frame is every call's time over their
    frames, not over the calls."""
    rec = stream(calls=3)
    assert S.first_units(rec, 7) == {1: 4, 2: 4}
    assert S.first_units(rec, 12) == {1: 4, 2: 4, 3: 3}
    monkeypatch.setattr(S, "records", lambda: rec)
    ctx = SimpleNamespace(traced_units=11)
    assert _reader("dispatch_ms_per_frame").read(ctx) == pytest.approx(
        6 * (1 + 2 + 3) / 11)
    assert _reader("host_syncs_per_frame").read(ctx) == pytest.approx(3 / 11)


READERS = sorted({c[0] for c in CASES})


@pytest.mark.parametrize("name", READERS)
def test_none_when_nothing_was_recorded(name, monkeypatch):
    ctx = SimpleNamespace(traced_units=20)
    monkeypatch.setattr(S, "records",
                        lambda: Records([], {}, {}, 0, (0, 0)))
    assert _reader(name).read(ctx) is None
    monkeypatch.setattr(S, "records", lambda: None)    # no tracer
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_none_from_a_program_without_the_tracer(name, monkeypatch):
    from autoposeestimation_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "records")
    assert S.records() is None
    assert _reader(name).read(SimpleNamespace(traced_units=20)) is None
