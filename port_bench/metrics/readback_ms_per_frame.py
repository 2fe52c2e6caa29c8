"""Host ms a served frame takes to read its results back and build the
prediction dict (`frame.readback` / `stream.readback`), in the first
traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("frame.readback", "stream.readback"))
