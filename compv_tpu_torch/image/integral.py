"""Summed-area tables and local moments (mirror of
``compv_tpu/image/integral.py``; reference
base/image/compv_image_integral.cxx).

The reference's default ``dtype=jnp.float64`` means, with JAX's 64-bit
mode off as on its TPU: int32 for an integer image, float32 otherwise. The
port reads ``torch.float64`` the same way; any other dtype, and the image,
follow the x64-off rule of every public entry (``core.types.x64_off_dtype``
and ``at_x64_off``: float64 is float32, int64 int32). ``torch.cumsum``
gets its dtype passed, since it returns int64 for an int32 input
otherwise. ``box_sum`` of a uint16 or uint32 table wraps in its dtype, in
int64 (PyTorch has no CPU ``-`` for them).

Integer tables are exact, and so is ``box_mean_var``'s centred int32 path.
Float32 prefix sums are not: XLA and PyTorch add in another order (on the
720p scene, ``integral_squared`` agrees within 3.5e-7 relative, not bit
for bit).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from compv_tpu_torch.core.types import (at_x64_off, is_integer_dtype,
                                       x64_off_dtype)
from compv_tpu_torch.math.ops import _wrap_to

__all__ = ["integral", "integral_squared", "box_sum", "box_mean_var"]


def _table_dtype(img: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    if dtype == torch.float64:      # the reference's default, x64 off
        return torch.int32 if is_integer_dtype(img.dtype) else torch.float32
    return x64_off_dtype(dtype)


@at_x64_off
def integral(img: torch.Tensor, dtype: torch.dtype = torch.float64
             ) -> torch.Tensor:
    """Integral image with a leading zero row and column: (..., H+1, W+1),
    out[i, j] = sum(img[:i, :j]). int32 tables are exact up to 2^31."""
    dtype = _table_dtype(img, dtype)
    s = torch.cumsum(torch.cumsum(img.to(dtype), dim=-2, dtype=dtype),
                     dim=-1, dtype=dtype)
    return F.pad(s, (1, 0, 1, 0))


@at_x64_off
def integral_squared(img: torch.Tensor, dtype: torch.dtype = torch.float64
                     ) -> torch.Tensor:
    """Integral image of the squared pixels (float32 by default)."""
    dtype = x64_off_dtype(dtype)
    f = img.to(dtype)
    return integral(f * f, dtype)


@at_x64_off
def box_sum(int_img: torch.Tensor, size: int) -> torch.Tensor:
    """Sliding size x size window sums from an integral image: (H - size
    + 1, W - size + 1)."""
    t = int_img
    if t.dtype in (torch.uint16, torch.uint32):
        t = t.to(torch.int64)
    a = t[..., size:, size:]
    b = t[..., size:, :-size]
    c = t[..., :-size, size:]
    d = t[..., :-size, :-size]
    if t is not int_img:
        return _wrap_to(a - b - c + d, int_img.dtype)
    return a - b - c + d


def _box1d(a: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Clipped window sums of radius ``r`` along ``dim`` (0 or 1) from one
    prefix sum: the prefix at min(i + r, n - 1) less the prefix before
    i - r (0 where the window is clipped)."""
    cs = torch.cumsum(a, dim=dim, dtype=a.dtype)
    n = cs.shape[dim]
    idx = torch.arange(n, device=a.device)
    hi = cs.index_select(dim, (idx + r).clamp_max(n - 1))
    zero = torch.zeros_like(cs.narrow(dim, 0, 1))
    before = torch.cat([zero, cs], dim=dim)   # before[i] = sum a[:i]
    lo = before.index_select(dim, (idx - r).clamp_min(0))
    return hi - lo


def _counts(h: int, w: int, r: int, dtype: torch.dtype, device
            ) -> torch.Tensor:
    xs = torch.arange(w, dtype=dtype, device=device)
    ys = torch.arange(h, dtype=dtype, device=device)
    cw = torch.clamp_max(xs + r, w - 1) - torch.clamp_min(xs - r, 0) + 1
    ch = torch.clamp_max(ys + r, h - 1) - torch.clamp_min(ys - r, 0) + 1
    return ch[:, None] * cw[None, :]


@at_x64_off
def box_mean_var(img: torch.Tensor, size: int):
    """Local mean and variance over clipped size x size windows, normalized
    by the true count: (mean f32, var f32). Exact centred int32 prefix
    sums while H * size * 16384 and W * size * 16384 stay below 2^31 (the
    squared prefix then fits int32), float32 sums past that."""
    h, w = img.shape
    r = size // 2
    if h * size * 16384 >= 2 ** 31 or w * size * 16384 >= 2 ** 31:
        f = img.to(torch.float32)
        mean = _box_mean_f32(f, size)
        var = torch.clamp_min(_box_mean_f32(f * f, size) - mean * mean, 0.0)
        return mean, var
    v = img.to(torch.int32) - 128
    s1 = _box1d(_box1d(v, r, 1), r, 0)
    s2 = _box1d(_box1d(v * v, r, 1), r, 0)
    cnt = _counts(h, w, r, torch.int32, img.device).to(torch.float32)
    m_c = s1.to(torch.float32) / cnt
    var = torch.clamp_min(s2.to(torch.float32) / cnt - m_c * m_c, 0.0)
    return m_c + 128.0, var


def _box_mean_f32(f: torch.Tensor, size: int) -> torch.Tensor:
    h, w = f.shape
    r = size // 2
    cnt = _counts(h, w, r, torch.float32, f.device)
    return _box1d(_box1d(f, r, 1), r, 0) / cnt
