"""Host ms of a training step's `ClippedAdam.step` (`step.optimizer`: the
clip's norms and Adam), in the first traced window."""
from harness.spans import ms_per_unit


def read(ctx):
    return ms_per_unit(ctx, ("step.optimizer",))
