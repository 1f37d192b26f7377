"""Separable and 2-D convolution, Gaussian kernels and blurs, and the
reference's fixed-point (Q0.16) blur (mirror of ``compv_tpu/ops/conv.py``).

The blur feeds BRIEF, which compares blurred u8 values, so one LSB flips a
descriptor bit. The port therefore keeps the reference's arithmetic exactly:
horizontal pass then vertical, taps in order, each tap a separate f32
multiply and add over a slice of one zero-padded buffer. Up to 31 taps (a
separable kernel) or 62 (a 2-D stencil) the reference shift-adds; above
that it calls XLA's convolution, and so does the port call ``F.conv2d``
(TF32 is off in the package init; the sums run in cuDNN's order, so that
branch agrees with the reference within a tolerance, not bit for bit).

The Q0.16 path is integer arithmetic and bit-exact: per tap
``(u8 * u16) >> 16``, summed, clipped to [0, 255], vertical pass then
horizontal with a u8 intermediate (compv_math_convlt.h:386-404).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel1d", "gaussian_kernel2d", "convolve_separable",
           "convolve2d", "gaussian_blur", "fixed_point_kernel",
           "convolve_separable_q16", "gaussian_blur_q16"]

# kernels up to this many taps use the shift-and-add formulation; beyond it
# the library convolution
_SHIFT_ADD_MAX_TAPS = 31


def gaussian_kernel1d(size: int, sigma: float) -> torch.Tensor:
    """Normalized 1-D Gaussian (reference CompVMathGauss::kernelDim1; the
    ORB descriptor uses size=5 sigma=2.0). Copy of the reference helper,
    returning a CPU f32 tensor: the taps are host constants."""
    return torch.from_numpy(_gaussian_taps(size, sigma))


def gaussian_kernel2d(size: int, sigma: float) -> torch.Tensor:
    k = _gaussian_taps(size, sigma)
    return torch.from_numpy(np.outer(k, k).astype(np.float32))


def _gaussian_taps(size: int, sigma: float) -> np.ndarray:
    if size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {size}")
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _pad_hw(f: torch.Tensor, ph: int, pw: int, border: str) -> torch.Tensor:
    """(..., H, W) padded by ph rows and pw columns on each side."""
    if border == "zero":
        return F.pad(f, (pw, pw, ph, ph))
    if border == "replicate":
        h, w = f.shape[-2:]
        ys = torch.arange(-ph, h + ph, device=f.device).clamp(0, h - 1)
        xs = torch.arange(-pw, w + pw, device=f.device).clamp(0, w - 1)
        return f.index_select(-2, ys).index_select(-1, xs)
    raise ValueError(border)


def _library_conv(f: torch.Tensor, kernel: np.ndarray, border: str
                  ) -> torch.Tensor:
    """Correlation of (..., H, W) f32 with a (kh, kw) kernel by F.conv2d
    (the reference's conv_general_dilated branch)."""
    kh, kw = kernel.shape
    lead = f.shape[:-2]
    h, w = f.shape[-2:]
    x = _pad_hw(f.reshape(-1, 1, h, w), kh // 2, kw // 2, border)
    wk = torch.as_tensor(kernel, dtype=torch.float32,
                         device=f.device).reshape(1, 1, kh, kw)
    return F.conv2d(x, wk).reshape(*lead, h, w)


def _conv1d_axis(f: torch.Tensor, taps: np.ndarray, axis: int, border: str
                 ) -> torch.Tensor:
    """1-D correlation along ``axis`` (-1 or -2) of (..., H, W) f32 by
    shift-and-add over static slices of one padded buffer."""
    half = len(taps) // 2
    size = f.shape[axis]
    padded = (_pad_hw(f, 0, half, border) if axis == -1
              else _pad_hw(f, half, 0, border))
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
    kh = _host_taps(kh)
    kv = _host_taps(kv)
    f = img.to(torch.float32)
    if max(len(kh), len(kv)) <= _SHIFT_ADD_MAX_TAPS:
        y = _conv1d_axis(f, kh, -1, border)
        return _conv1d_axis(y, kv, -2, border)
    y = _library_conv(f, kh[None, :], border)
    return _library_conv(y, kv[:, None], border)


def _host_taps(k) -> np.ndarray:
    if isinstance(k, torch.Tensor):
        k = k.detach().cpu().numpy()
    return np.array(k, np.float32)


def convolve2d(img: torch.Tensor, kernel, border: str = "zero"
               ) -> torch.Tensor:
    """Dense 2-D correlation (no flip; reference convlt2) with a (kh, kw)
    kernel of host constants. Returns float32."""
    kern = _host_taps(kernel)
    f = img.to(torch.float32)
    kh, kw = kern.shape
    if kh * kw > _SHIFT_ADD_MAX_TAPS * 2:
        return _library_conv(f, kern, border)
    hh, ww = f.shape[-2:]
    padded = _pad_hw(f, kh // 2, kw // 2, border)
    out = None
    for i in range(kh):
        for j in range(kw):
            kij = float(kern[i, j])
            if kij == 0.0:
                continue            # zero taps cost nothing
            term = padded[..., i:i + hh, j:j + ww] * kij
            out = term if out is None else out + term
    return torch.zeros_like(f) if out is None else out


def gaussian_blur(img: torch.Tensor, size: int = 5, sigma: float = 2.0,
                  border: str = "zero") -> torch.Tensor:
    """Gaussian blur; u8 in -> u8 out (round half to even, clamp), float in
    -> float out."""
    k = _gaussian_taps(size, sigma)
    out = convolve_separable(img, k, k, border)
    if not img.dtype.is_floating_point:
        return out.round().clamp(0, 255).to(img.dtype)
    return out.to(img.dtype)


def fixed_point_kernel(kernel) -> np.ndarray:
    """Quantize a normalized (>= 0, sums to about 1) float kernel to u16
    Q0.16, coefficient * 0xffff truncated (CompVMathConvlt::fixedPointKernel,
    compv_math_convlt.h:75-92). Copy of the reference helper."""
    k = np.asarray(kernel, np.float64)
    if (k < 0).any():
        raise ValueError("fixed-point kernel coefficients must be >= 0")
    return (k * 0xFFFF).astype(np.uint16)


def _q16_pass(x: torch.Tensor, kern: np.ndarray, axis: int) -> torch.Tensor:
    """One fixed-point pass over (H, W) i32 along ``axis`` (0 rows, 1
    columns), zero borders: per tap (u8 * u16) >> 16, summed, clipped."""
    taps = len(kern)
    r = taps // 2
    h, w = x.shape
    p = F.pad(x, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    acc = torch.zeros((h, w), dtype=torch.int32, device=x.device)
    for t in range(taps):
        sl = p[t:t + h, :] if axis == 0 else p[:, t:t + w]
        acc = acc + ((sl * int(kern[t])) >> 16)
    return acc.clamp(0, 255)


def convolve_separable_q16(img: torch.Tensor, vt_kern: tuple,
                           hz_kern: tuple) -> torch.Tensor:
    """Separable fixed-point u8 convolution with Q0.16 u16 kernels (tuples
    of Python ints): vertical pass, then horizontal (reference
    convlt1FixedPoint, compv_math_convlt.h:31-34). (H, W) u8 -> u8."""
    vt = np.asarray(vt_kern, np.uint16)
    hz = np.asarray(hz_kern, np.uint16)
    x = _q16_pass(img.to(torch.int32), vt, 0)
    return _q16_pass(x, hz, 1).to(torch.uint8)


def gaussian_blur_q16(img: torch.Tensor, size: int = 5, sigma: float = 2.0
                      ) -> torch.Tensor:
    """The reference's fixed-point Gaussian blur: Gaussian kernel ->
    fixedPointKernel -> convlt1FixedPoint."""
    kq = tuple(int(v) for v in fixed_point_kernel(_gaussian_taps(size, sigma)))
    return convolve_separable_q16(img, kq, kq)
