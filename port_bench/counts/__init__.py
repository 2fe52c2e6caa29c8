"""Frozen counts: the FLOPs of a frame and of a training step of each
configuration (`flops.json`, written by `count.py`), the counting rule
they were taken by (`rules.py`), and the least time of the hand kernels
(`bounds.py`)."""
