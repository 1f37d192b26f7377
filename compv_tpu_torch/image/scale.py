"""Bilinear image scaling (mirror of ``compv_tpu/image/scale.py``).

Half-pixel centers: dst x samples src (x + 0.5) * (src_n / dst_n) - 0.5.
The reference multiplies an f32 coordinate vector by the Python ratio in
f32; the port rounds the ratio to f32 itself, so the products, and the u8
output, are bit-identical on CPU and CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["scale", "scale_bilinear"]


def _src_coords(dst_n: int, src_n: int, device) -> torch.Tensor:
    s = float(np.float32(src_n / dst_n))
    return (torch.arange(dst_n, dtype=torch.float32, device=device) + 0.5) * s - 0.5


def scale_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H,W[,C]) u8/f32 -> (out_h,out_w[,C]) same dtype."""
    h, w = img.shape[:2]
    f = img.to(torch.float32)
    yf = _src_coords(out_h, h, img.device).clamp(0.0, h - 1.0)
    xf = _src_coords(out_w, w, img.device).clamp(0.0, w - 1.0)
    y0 = yf.floor().to(torch.int64)
    x0 = xf.floor().to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (yf - y0)[:, None]
    wx = (xf - x0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]

    r0 = f.index_select(0, y0)
    r1 = f.index_select(0, y1)
    top = r0.index_select(1, x0) * (1 - wx) + r0.index_select(1, x1) * wx
    bot = r1.index_select(1, x0) * (1 - wx) + r1.index_select(1, x1) * wx
    out = top * (1 - wy) + bot * wy
    if not img.dtype.is_floating_point:
        out = out.round().clamp(0, 255)
    return out.to(img.dtype)


def scale(img: torch.Tensor, out_h: int, out_w: int,
          interpolation: str = "bilinear") -> torch.Tensor:
    """Facade matching CompVImage::scale; this port has bilinear only."""
    if interpolation == "bilinear":
        return scale_bilinear(img, out_h, out_w)
    raise ValueError(f"unknown interpolation {interpolation!r}")
