"""Gradient edge detectors: Sobel / Scharr / Prewitt (mirror of
``compv_tpu/features/edges.py``).

The two separable passes run on ``ops/conv.convolve_separable``, the
reference's shift-and-add order, so ``sobel_gradients`` and ``edge_detect``
are bit-equal to the reference. ``gradient_magnitude_direction``'s
direction is ``torch.atan2``, which may differ from XLA's ``arctan2`` by an
ulp.
"""
from __future__ import annotations

import numpy as np
import torch

from compv_tpu_torch.ops.conv import convolve_separable

__all__ = ["sobel_gradients", "edge_detect", "KERNELS",
           "gradient_magnitude_direction"]

# separable (smooth, derive) pairs: copy of compv_tpu/features/edges.py:19-23
KERNELS = {
    "sobel": (np.array([1.0, 2.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
    "scharr": (np.array([3.0, 10.0, 3.0]), np.array([-1.0, 0.0, 1.0])),
    "prewitt": (np.array([1.0, 1.0, 1.0]), np.array([-1.0, 0.0, 1.0])),
}


def sobel_gradients(img: torch.Tensor, operator: str = "sobel"):
    """Returns (gx, gy) float32, same shape. gx = horizontal derivative."""
    smooth, deriv = KERNELS[operator]
    f = img.to(torch.float32)
    gx = convolve_separable(f, deriv, smooth)   # derive along x, smooth y
    gy = convolve_separable(f, smooth, deriv)
    return gx, gy


def gradient_magnitude_direction(gx: torch.Tensor, gy: torch.Tensor,
                                 l2: bool = False):
    """Magnitude (L1 by default, like the reference's Canny) and direction
    in radians [-pi, pi]."""
    if l2:
        mag = torch.sqrt(gx * gx + gy * gy)
    else:
        mag = gx.abs() + gy.abs()
    return mag, torch.atan2(gy, gx)


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
