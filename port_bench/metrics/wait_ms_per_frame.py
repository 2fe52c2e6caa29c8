"""Host ms a served frame waits on the device: `frame.wait` (the read of
`found`) / `stream.wait` (a call's event, over its frames), in the first
traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("frame.wait", "stream.wait"))
