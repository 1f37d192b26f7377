"""Gradient edge detectors: Sobel / Scharr / Prewitt (mirror of
``compv_tpu/features/edges.py``).

The two separable passes run on ``ops/conv.convolve_separable``, the
reference's shift-and-add order, so ``sobel_gradients`` and ``edge_detect``
are bit-equal to the reference. ``gradient_magnitude_direction``'s
direction is ``torch.atan2``, which may differ from XLA's ``arctan2`` by an
ulp. Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import numpy as np
import torch

from compv_tpu_torch.core.types import at_x64_off, is_integer_dtype
from compv_tpu_torch.math.ops import _wrap, _wrap_mul
from compv_tpu_torch.ops.conv import convolve_separable

__all__ = ["sobel_gradients", "edge_detect", "KERNELS",
           "gradient_magnitude_direction"]

# separable (smooth, derive) pairs: copy of compv_tpu/features/edges.py:19-23
KERNELS = {
    "sobel": (np.array([1.0, 2.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
    "scharr": (np.array([3.0, 10.0, 3.0]), np.array([-1.0, 0.0, 1.0])),
    "prewitt": (np.array([1.0, 1.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
}


@at_x64_off
def sobel_gradients(img: torch.Tensor, operator: str = "sobel"):
    """Returns (gx, gy) float32, same shape. gx = horizontal derivative."""
    smooth, deriv = KERNELS[operator]
    f = img.to(torch.float32)
    gx = convolve_separable(f, deriv, smooth)   # derive along x, smooth y
    gy = convolve_separable(f, smooth, deriv)
    return gx, gy


@at_x64_off
def gradient_magnitude_direction(gx: torch.Tensor, gy: torch.Tensor,
                                 l2: bool = False):
    """Magnitude (L1 by default, like the reference's Canny) and direction
    in radians [-pi, pi]. Integer gradients keep the reference's dtypes:
    the L1 magnitude in theirs (wrapping), the L2 one and the direction
    float32."""
    if is_integer_dtype(gx.dtype):
        dt = gx.dtype               # the reference's wrap-around in dt
        x, y = gx.to(torch.int64), gy.to(torch.int64)
        if l2:
            s = _wrap(_wrap_mul(x, x, dt) + _wrap_mul(y, y, dt), dt)
            mag = torch.sqrt(s.to(torch.float32))
        else:
            mag = _wrap(_wrap(x.abs(), dt) + _wrap(y.abs(), dt), dt).to(dt)
        return mag, torch.atan2(y.to(torch.float32), x.to(torch.float32))
    if l2:
        mag = torch.sqrt(gx * gx + gy * gy)
    else:
        mag = gx.abs() + gy.abs()
    return mag, torch.atan2(gy, gx)


@at_x64_off
def edge_detect(img: torch.Tensor, operator: str = "sobel",
                scale: float | None = None) -> torch.Tensor:
    """|gx|+|gy| scaled and clamped to u8 (the reference's edge-detector
    output contract)."""
    gx, gy = sobel_gradients(img, operator)
    mag = gx.abs() + gy.abs()
    if scale is None:
        # the maximum possible |gx|+|gy| response maps to 255
        smooth, deriv = KERNELS[operator]
        max_resp = (2.0 * np.abs(smooth).sum() * np.abs(deriv).sum()
                    * 255.0 / 2.0)
        scale = 255.0 / max_resp
    s = torch.tensor(np.float32(scale), device=img.device)
    return torch.clamp(mag * s, 0, 255).to(torch.uint8)
