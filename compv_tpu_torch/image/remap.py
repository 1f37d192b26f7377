"""Map-based resampling: remap, perspective and affine warps (mirror of
``compv_tpu/image/remap.py``; reference CompVImageRemap::process,
base/image/compv_image_remap.cxx:417, and CompVImage::warpInverse,
compv_image.h:74-75). A remap is a 2D gather and a lerp over the
destination grid.
"""
from __future__ import annotations

import torch

__all__ = ["remap_bilinear", "remap_nearest", "warp_perspective",
           "warp_affine"]


def _sample_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                     fill: float = 0.0) -> torch.Tensor:
    """Sample img (H, W[, C]) at float coords (xs, ys) of any common shape,
    bilinear; out-of-range -> fill."""
    h, w = img.shape[:2]
    f = img.to(torch.float32)
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    xc = xs.clamp(0.0, w - 1.0)
    yc = ys.clamp(0.0, h - 1.0)
    x0 = xc.floor().to(torch.int64)
    y0 = yc.floor().to(torch.int64)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    tx = xc - x0
    ty = yc - y0
    if img.ndim == 3:
        tx, ty, inside = tx[..., None], ty[..., None], inside[..., None]
    top = f[y0, x0] * (1 - tx) + f[y0, x1] * tx
    bot = f[y1, x0] * (1 - tx) + f[y1, x1] * tx
    out = top * (1 - ty) + bot * ty
    return torch.where(inside, out, fill)


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """dst[i, j] = img(map_y[i, j], map_x[i, j]), bilinear (the reference's
    COMPV_INTERPOLATION_TYPE_BILINEAR); integer images are rounded (half to
    even) and clipped to [0, 255]."""
    out = _sample_bilinear(img, map_x.to(torch.float32),
                           map_y.to(torch.float32), fill)
    if not img.dtype.is_floating_point:
        out = out.round().clamp(0, 255)
    return out.to(img.dtype)


def remap_nearest(img: torch.Tensor, map_x: torch.Tensor,
                  map_y: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    h, w = img.shape[:2]
    xs = map_x.round().to(torch.int64)
    ys = map_y.round().to(torch.int64)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out = img[ys.clamp(0, h - 1), xs.clamp(0, w - 1)]
    if img.ndim == 3:
        inside = inside[..., None]
    return torch.where(inside, out, torch.tensor(fill, dtype=img.dtype,
                                                 device=img.device))


def _dst_grid(out_h: int, out_w: int, device):
    yy, xx = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=device),
        torch.arange(out_w, dtype=torch.float32, device=device),
        indexing="ij")
    return xx, yy


def warp_perspective(img: torch.Tensor, h_dst_to_src: torch.Tensor,
                     out_h: int, out_w: int, fill: float = 0.0
                     ) -> torch.Tensor:
    """Perspective warp; ``h_dst_to_src`` (3, 3) maps a destination pixel
    (x, y, 1) to source coordinates."""
    xx, yy = _dst_grid(out_h, out_w, img.device)
    hm = h_dst_to_src.to(torch.float32)
    den = hm[2, 0] * xx + hm[2, 1] * yy + hm[2, 2]
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    sx = (hm[0, 0] * xx + hm[0, 1] * yy + hm[0, 2]) / den
    sy = (hm[1, 0] * xx + hm[1, 1] * yy + hm[1, 2]) / den
    return remap_bilinear(img, sx, sy, fill)


def warp_affine(img: torch.Tensor, m_dst_to_src: torch.Tensor,
                out_h: int, out_w: int, fill: float = 0.0) -> torch.Tensor:
    """Affine warp with a (2, 3) dst -> src matrix."""
    xx, yy = _dst_grid(out_h, out_w, img.device)
    m = m_dst_to_src.to(torch.float32)
    sx = m[0, 0] * xx + m[0, 1] * yy + m[0, 2]
    sy = m[1, 0] * xx + m[1, 1] * yy + m[1, 2]
    return remap_bilinear(img, sx, sy, fill)
