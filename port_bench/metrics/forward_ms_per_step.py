"""Host ms of a training step's forward passes and losses
(`step.forward`), in the first traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("step.forward",))
