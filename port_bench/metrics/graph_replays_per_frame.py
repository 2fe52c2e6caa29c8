"""Replays of the captured frame graph a served frame (the program's
counter `graph_replays`: one a live frame, one a stream call), in the first
traced window. None where the program has no such counter, as where it
serves eagerly."""
from harness.spans import count_per_unit, records

NAME = "graph_replays"


def read(ctx):
    rec = records()
    if rec is None or NAME not in rec.counts:
        return None
    return count_per_unit(ctx, NAME)
