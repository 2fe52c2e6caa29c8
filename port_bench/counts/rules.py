"""The counting rule of the FLOP counts (a frozen copy of the measured
package's rule): `torch.utils.flop_counter.FlopCounterMode` counts the
matmuls and convolutions from their shapes, forward and backward, with a
convolution counting only the taps that land inside its input, as XLA's
cost analysis counts it. The symmetric-loss kernels, which the counter
cannot see, count by closed forms: XLA's count of the plain version of the
same function."""
from __future__ import annotations

import contextlib


def _valid_taps(size, kernel, stride, pad, dilation, out) -> int:
    return sum(1 for o in range(out) for k in range(kernel)
               if 0 <= o * stride + k * dilation - pad < size)


def _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                      out_shape) -> int:
    taps = 1
    for d in range(2, len(x_shape)):
        taps *= _valid_taps(x_shape[d], w_shape[d], stride[d - 2],
                            padding[d - 2], dilation[d - 2], out_shape[d])
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs) -> int:
    if transposed:
        raise NotImplementedError("no transposed convolution is counted")
    return _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                             out_shape)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None,
                        **kwargs) -> int:
    fwd = _conv_valid_flops(x_shape, w_shape, stride, padding, dilation,
                            grad_out_shape)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _mapping() -> dict:
    import torch

    aten = torch.ops.aten
    return {aten.convolution: _conv_flop, aten._convolution: _conv_flop,
            aten.convolution_backward: _conv_backward_flop}


@contextlib.contextmanager
def counting():
    """Yields a FlopCounterMode; read `get_total_flops()` after."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False, custom_mapping=_mapping())
    with mode:
        yield mode


def moments_flops(b: int, n: int, m: int) -> int:
    """The symmetric moments' forward at (B, N, M): per candidate the
    (M, M) expansion-form distances and their minimum (10 M^2), the
    transformed points, norms, mean and std (33 M + 49); per sample the
    targets' norms (5 M)."""
    return b * (n * (10 * m * m + 33 * m + 49) + 5 * m)


def moments_grad_flops(b: int, n: int, m: int) -> int:
    """Their backward: the argmin recompute and each candidate's gradient,
    17 M^2 + 76 M + 184 a candidate."""
    return b * n * (17 * m * m + 76 * m + 184)
