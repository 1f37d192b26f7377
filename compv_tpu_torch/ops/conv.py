"""Separable convolution and Gaussian blur (mirror of
``compv_tpu/ops/conv.py``'s shift-and-add path).

The blur feeds BRIEF, which compares blurred u8 values, so one LSB flips a
descriptor bit. The port therefore keeps the reference's arithmetic exactly:
horizontal pass then vertical, taps in order, each tap a separate f32
multiply and add over a slice of one zero-padded buffer. ``F.conv2d`` is
avoided on purpose: on CUDA, cuDNN runs f32 convolutions in TF32 by default
and sums in another order.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gaussian_kernel1d", "convolve_separable", "gaussian_blur"]


def gaussian_kernel1d(size: int, sigma: float) -> torch.Tensor:
    """Normalized 1-D Gaussian (reference CompVMathGauss::kernelDim1; the
    ORB descriptor uses size=5 sigma=2.0). Copy of the reference helper,
    returning a CPU f32 tensor: the taps are host constants."""
    return torch.from_numpy(_gaussian_taps(size, sigma))


def _gaussian_taps(size: int, sigma: float) -> np.ndarray:
    if size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {size}")
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _conv1d_axis(f: torch.Tensor, taps: np.ndarray, axis: int, border: str
                 ) -> torch.Tensor:
    """1-D correlation along ``axis`` (-1 or -2) of (..., H, W) f32 by
    shift-and-add over static slices of one padded buffer."""
    n = len(taps)
    half = n // 2
    size = f.shape[axis]
    if border == "zero":
        shape = list(f.shape)
        shape[axis] = size + 2 * half
        padded = f.new_zeros(shape)
        padded.narrow(axis, half, size).copy_(f)
    elif border == "replicate":
        src = torch.arange(-half, size + half, device=f.device).clamp(0, size - 1)
        padded = f.index_select(axis, src)
    else:
        raise ValueError(border)
    out = None
    for i, k in enumerate(taps.tolist()):
        term = padded.narrow(axis, i, size) * k
        out = term if out is None else out + term
    return out


def convolve_separable(img: torch.Tensor, kh, kv, border: str = "zero"
                       ) -> torch.Tensor:
    """Separable correlation: horizontal pass with ``kh``, then vertical
    with ``kv``. Returns float32. The taps are host constants (numpy arrays,
    sequences or CPU tensors), as they are static in the reference."""
    kh = np.asarray(kh, np.float32)
    kv = np.asarray(kv, np.float32)
    f = img.to(torch.float32)
    y = _conv1d_axis(f, kh, -1, border)
    return _conv1d_axis(y, kv, -2, border)


def gaussian_blur(img: torch.Tensor, size: int = 5, sigma: float = 2.0,
                  border: str = "zero") -> torch.Tensor:
    """Gaussian blur; u8 in -> u8 out (round half to even, clamp), float in
    -> float out."""
    k = _gaussian_taps(size, sigma)
    out = convolve_separable(img, k, k, border)
    if not img.dtype.is_floating_point:
        return out.round().clamp(0, 255).to(img.dtype)
    return out.to(img.dtype)
