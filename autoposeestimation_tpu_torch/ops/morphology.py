"""Grayscale morphology and box smoothing (port of
`autoposeestimation_tpu/ops/morphology.py`): flat square kernels as
window minima and maxima over (H, W) images.

OpenCV anchors a flat kernel at (k//2, k//2), so a window spans
[-k//2, k-1-k//2]: symmetric for odd kernels, one pixel more before than
after for even ones (the labeling's open and close kernels of 6).
`F.max_pool2d` pads symmetrically only, so the image is padded here with
the border value (+inf for erosion, -inf for dilation) and pooled without
padding. Integer images pool through f64, which holds their values
exactly; the window always holds its own pixel, so the border value never
wins and the JAX version's integer borders (the type's max or min) give
the same result. The box filter pads with REFLECT_101
(`F.pad(mode="reflect")`) and sums the window in row-major order from 0,
as XLA's `reduce_window` does, in f32 elementwise adds (the same bits on
every device, whatever the convolution precision), then divides by k^2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_filter(img: torch.Tensor, kernel_size: int, border: float
                ) -> torch.Tensor:
    """Max over each pixel's OpenCV-anchored window, `border` outside."""
    x = img if img.dtype.is_floating_point else img.to(torch.float64)
    lo = kernel_size // 2
    hi = kernel_size - 1 - lo
    padded = F.pad(x, (lo, hi, lo, hi), value=border)
    return F.max_pool2d(padded[None, None], kernel_size, 1)[0, 0].to(
        img.dtype)


def erode(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Window minimum over a kernel_size x kernel_size flat element."""
    x = img if img.dtype.is_floating_point else img.to(torch.float64)
    return (-_max_filter(-x, kernel_size, -torch.inf)).to(img.dtype)


def dilate(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Window maximum over a kernel_size x kernel_size flat element."""
    return _max_filter(img, kernel_size, -torch.inf)


def opening(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Erode, then dilate (cv2.MORPH_OPEN)."""
    return dilate(erode(img, kernel_size), kernel_size)


def closing(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Dilate, then erode (cv2.MORPH_CLOSE)."""
    return erode(dilate(img, kernel_size), kernel_size)


def box_smooth(img: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Normalized box filter with a REFLECT_101 border, in f32."""
    pad = kernel_size // 2
    padded = F.pad(img.to(torch.float32)[None, None],
                   (pad, pad, pad, pad), mode="reflect")[0, 0]
    h, w = (n - kernel_size + 1 for n in padded.shape)
    summed = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for di in range(kernel_size):
        for dj in range(kernel_size):
            summed = summed + padded[di:di + h, dj:dj + w]
    return (summed / (kernel_size * kernel_size)).to(img.dtype)
