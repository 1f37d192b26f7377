"""Image resampling: bilinear, bicubic and nearest scaling, and rotations
(mirror of ``compv_tpu/image/scale.py``; reference
compv_image_scale_bilinear.cxx, compv_image_scale_bicubic.cxx and
CompVImage::scale, compv_image.cxx:852).

Half-pixel centers: dst x samples src (x + 0.5) * (src_n / dst_n) - 0.5.
The reference multiplies an f32 coordinate vector by the Python ratio in
f32; the port rounds the ratio to f32 itself, so the products, and the u8
output, are bit-identical on CPU and CUDA.

``rotate_fast`` is the reference's three-shear rotation (Paeth 1986) on an
expanded canvas: each shear is a per-line roll (a barrel shifter of
uniform rolls and selects, as the reference builds it) and a lerp between
neighbouring integer shifts.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import numpy as np
import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.image.remap import warp_affine

__all__ = ["scale", "scale_bilinear", "scale_bicubic", "scale_nearest",
           "rotate_bilinear", "rotate_fast"]

_DEG2RAD = float(np.float32(np.pi / 180))   # jnp.deg2rad's f32 factor


def _src_coords(dst_n: int, src_n: int, device) -> torch.Tensor:
    s = float(np.float32(src_n / dst_n))
    return (torch.arange(dst_n, dtype=torch.float32, device=device) + 0.5) * s - 0.5


@at_x64_off
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


@at_x64_off
def scale_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[:2]
    ys = _src_coords(out_h, h, img.device).round().to(torch.int64).clamp(0, h - 1)
    xs = _src_coords(out_w, w, img.device).round().to(torch.int64).clamp(0, w - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _cubic_weights(t: torch.Tensor, a: float = -0.5):
    """Keys cubic weights for taps at offsets -1, 0, 1, 2 of a fractional
    offset t in [0, 1) (compv_image_scale_bicubic.cxx)."""
    t2 = t * t
    t3 = t2 * t
    w0 = a * (t3 - 2 * t2 + t)
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w3 = a * (-t3 + t2)
    return w0, w1, w2, w3


@at_x64_off
def scale_bicubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w = img.shape[:2]
    f = img.to(torch.float32)
    yf = _src_coords(out_h, h, img.device).clamp(0.0, h - 1.0)
    xf = _src_coords(out_w, w, img.device).clamp(0.0, w - 1.0)
    y0 = yf.floor().to(torch.int64)
    x0 = xf.floor().to(torch.int64)
    wys = _cubic_weights(yf - y0)
    wxs = _cubic_weights(xf - x0)
    extra = (None,) if img.ndim == 3 else ()
    out = None
    for dy, wy in zip((-1, 0, 1, 2), wys):
        rows = f.index_select(0, (y0 + dy).clamp(0, h - 1))
        acc = None
        for dx, wx in zip((-1, 0, 1, 2), wxs):
            v = rows.index_select(1, (x0 + dx).clamp(0, w - 1))
            term = v * wx[(None, slice(None)) + extra]
            acc = term if acc is None else acc + term
        term = acc * wy[(slice(None), None) + extra]
        out = term if out is None else out + term
    if not img.dtype.is_floating_point:
        out = out.round().clamp(0, 255)
    return out.to(img.dtype)


@at_x64_off
def scale(img: torch.Tensor, out_h: int, out_w: int,
          interpolation: str = "bilinear") -> torch.Tensor:
    """Facade matching CompVImage::scale (compv_image.cxx:852)."""
    if interpolation == "bilinear":
        return scale_bilinear(img, out_h, out_w)
    if interpolation == "bicubic":
        return scale_bicubic(img, out_h, out_w)
    if interpolation == "nearest":
        return scale_nearest(img, out_h, out_w)
    raise ValueError(f"unknown interpolation {interpolation!r}")


@at_x64_off
def rotate_bilinear(img: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rotate about the image center with bilinear sampling (the
    reference's rotate benchmark, through a warp)."""
    h, w = img.shape[:2]
    th = torch.as_tensor(angle_deg, dtype=torch.float32,
                         device=img.device) * _DEG2RAD
    c, s = th.cos(), th.sin()
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    rot = torch.stack([torch.stack([c, s, cx - c * cx - s * cy]),
                       torch.stack([-s, c, cy + s * cx - c * cy])])
    return warp_affine(img, rot, h, w)


def _roll_lines(x: torch.Tensor, shifts: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """Roll each line of a 2-D array along ``axis`` left (up) by its own
    amount, one shift per line of the other axis: log2(n) uniform rolls,
    each taken by the lines whose shift has that bit set."""
    n = x.shape[axis]
    shifts = torch.remainder(shifts.to(torch.int64), n)
    nbits = max(int(np.ceil(np.log2(n))), 1)
    mask_shape = (-1, 1) if axis == 1 else (1, -1)
    for b in range(nbits):
        rolled = torch.roll(x, -(1 << b), dims=axis)
        take = ((shifts >> b) & 1) == 1
        x = torch.where(take.reshape(mask_shape), rolled, x)
    return x


def _shear(x: torch.Tensor, factor: torch.Tensor, axis: int) -> torch.Tensor:
    """Sub-pixel shear about the canvas center: line i (of the other axis)
    moves by factor * (i - center) along ``axis``, a lerp between the
    integer roll and the integer roll + 1."""
    other = 1 - axis
    n_lines = x.shape[other]
    center = (n_lines - 1) / 2.0
    t = -factor * (torch.arange(n_lines, dtype=torch.float32,
                                device=x.device) - center)
    k = t.floor()
    f = t - k
    a = _roll_lines(x, k.to(torch.int64), axis)
    b = torch.roll(a, -1, dims=axis)
    fm = f.reshape((-1, 1) if axis == 1 else (1, -1))
    return a * (1.0 - fm) + b * fm


@at_x64_off
def rotate_fast(img: torch.Tensor, angle_deg) -> torch.Tensor:
    """Rotation by three shears on an expanded canvas: shear_x(-tan(a/2)),
    shear_y(sin a), shear_x(-tan(a/2)). ``angle_deg`` in [-45, 45] (a
    number or a 0-d tensor). Returns the (S, S) f32 canvas that holds the
    whole rotated image."""
    h, w = img.shape
    s_can = int(np.ceil(1.5 * float(np.hypot(h, w)))) // 2 * 2
    py = (s_can - h) // 2
    px = (s_can - w) // 2
    canvas = torch.zeros((s_can, s_can), dtype=torch.float32,
                         device=img.device)
    canvas[py:py + h, px:px + w] = img.to(torch.float32)
    th = torch.as_tensor(angle_deg, dtype=torch.float32,
                         device=img.device) * _DEG2RAD
    alpha = -(th / 2.0).tan()
    beta = th.sin()
    canvas = _shear(canvas, alpha, axis=1)
    canvas = _shear(canvas, beta, axis=0)
    return _shear(canvas, alpha, axis=1)
