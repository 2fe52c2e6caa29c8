"""Blocking device-to-host reads a served frame (the program's counter
`host_syncs`), in the first traced window."""
from harness.spans import count_per_unit


def read(ctx):
    return count_per_unit(ctx, "host_syncs")
