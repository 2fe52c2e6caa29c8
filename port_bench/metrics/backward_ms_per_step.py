"""Host ms of a training step's `backward()` (`step.backward`), in the
first traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("step.backward",))
