"""Host ms of SegNet's index pooling and unpooling (`segnet.pool`,
`segnet.unpool`: five of each a forward) a training step, in the first
traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("segnet.pool", "segnet.unpool"))
