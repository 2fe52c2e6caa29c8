"""Data x tensor parallelism over `torch.distributed` (port of
`autoposeestimation_tpu/parallel/`)."""
