"""Kernels launched a training step (profiler)."""
from harness.readers import launches_per_unit as read  # noqa: F401
