"""PyTorch/CUDA port of `autoposeestimation_tpu`.

The JAX package stays the reference; this package mirrors its module paths
(`models/`, `ops/`, `pipeline/`, `train/`, `utils/`, `experiments/`) and holds
each module to its counterpart in `tests/test_torch_*.py`. It imports neither
JAX nor anything of the JAX package.

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`utils.device.resolve_device`). Hand-written CUDA kernels live in `csrc/`
and are built at first use into `build/kernels/` at the repository root.
"""
