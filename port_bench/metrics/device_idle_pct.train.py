"""The device's idle share of a training window: its busy time a unit from
the profiler, the units a second from the host clock."""
from harness.readers import idle_pct as read  # noqa: F401
