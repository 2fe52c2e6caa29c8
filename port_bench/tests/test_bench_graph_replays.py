"""The reader of the program's counter `graph_replays`
(`metrics/graph_replays_per_frame.py`) on fabricated records of the port's
tracer: one replay a live frame reads 1, one a stream call of four frames
0.25, and None comes back where the program counts no replays (it serves
eagerly, as before the frame graph was captured) or has no tracer."""
from types import SimpleNamespace

import pytest

from autoposeestimation_tpu_torch.utils.timing import Records
from harness import spans as S
from test_bench_spans import _reader, live, stream


def _with_replays(make, units):
    rec = make()
    counts = dict(rec.counts, graph_replays={u: 1 for u in range(1, units + 1)})
    return rec._replace(counts=counts, counters={
        name: sum(c.values()) for name, c in counts.items()})


@pytest.mark.parametrize("make,units,traced,want", [
    (live, 3, 2, 1.0),
    (stream, 3, 8, 2 / 8),
    (stream, 3, 11, 3 / 11),
], ids=["live", "stream", "stream-short-call"])
def test_reads_replays_over_frames(make, units, traced, want, monkeypatch):
    rec = _with_replays(make, units)
    monkeypatch.setattr(S, "records", lambda: rec)
    got = _reader("graph_replays_per_frame").read(
        SimpleNamespace(traced_units=traced))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("records", [
    live(), stream(), Records([], {}, {}, 0, (0, 0)), None],
    ids=["eager-live", "eager-stream", "empty", "no-tracer"])
def test_none_without_the_counter(records, monkeypatch):
    monkeypatch.setattr(S, "records", lambda: records)
    assert _reader("graph_replays_per_frame").read(
        SimpleNamespace(traced_units=20)) is None
