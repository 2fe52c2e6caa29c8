"""The least time of the hand kernels, from their shapes, against the
published peaks of one H100 SXM (NVIDIA's data sheet, 700 W; the run
records the card's power limit beside every share).

`sym_moments_train` at (B, N, M): every candidate pose of every sample
puts M model points against M targets, B N M^2 distance evaluations. In
the expansion form a distance is a dot product of 5 terms, [p, 1, |p|^2]
. [-2t, |t|^2, 1]: 10 FLOPs on the tensor cores at the peak of the mode's
precision (bf16 989 TFLOP/s; f32 as TF32, 495). Each point's minimum over
its M targets takes a compare a pair on the FP32 lanes (132 SMs x 128
lanes x 1.98 GHz). Inputs are read once and the (B, N, 32) rows written
once, at 3.35 TB/s. The three work on different units at once, so the
least time is the largest of the three, whatever implements the kernel."""
from __future__ import annotations

TENSOR_PEAK = {"bf16": 989e12, "f32": 495e12}
LANE_OPS = 132 * 128 * 1.98e9
HBM = 3.35e12


def sym_moments_train_seconds(b: int, n: int, m: int,
                              precision: str = "bf16") -> float:
    pairs = b * n * m * m
    products = 10.0 * pairs / TENSOR_PEAK[precision]
    compares = pairs / LANE_OPS
    bytes_moved = 4 * (b * n * (9 + 3) + 2 * b * m * 3 + b * n * 32)
    return max(products, compares, bytes_moved / HBM)
