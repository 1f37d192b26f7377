"""Histogram ops: 256-bin counts, LUT application, equalization, axis
projections (mirror of ``compv_tpu/image/histogram.py``; reference
CompVMathHistogram, base/math/compv_math_histogram.cxx).

The reference builds the histogram and applies a LUT through one-hot
nibble matmuls, a device for the TPU's matrix unit. Both compute exact
functions: integer counts, and one table entry per pixel (a dot product
with a single nonzero term). ``torch.bincount`` and a gather
(``lut[img]``) compute the same values on every device.

The reference takes an image of any integer or float dtype: its one-hots
match v = int32(pixel) for v in [0, 256) and nothing else, so a pixel
outside that range is not counted and looks up 0. The port keeps that
rule (a float is truncated toward zero, NaN counts as 0, as XLA converts
it); a uint8 image takes the direct path.
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import x64_off

__all__ = ["histogram256", "equalize", "apply_lut256", "projection_x",
           "projection_y"]


def _check_image(img: torch.Tensor) -> None:
    if img.ndim < 2 or img.dtype == torch.bool or img.dtype.is_complex:
        raise ValueError(f"expected a (..., H, W) integer or float image, "
                         f"got {img.ndim}-D {img.dtype}")


def _bins(img: torch.Tensor):
    """(int32(v) of each pixel as the reference's one-hots read it, in
    int64; the mask of those in [0, 256), None for a uint8 image, whose
    pixels all are)."""
    if img.dtype == torch.uint8:
        return img.to(torch.int64), None
    if img.dtype.is_floating_point:
        # clamped first: outside [-1, 256] the int32 cast is not defined,
        # and every such value is out of range either way
        img = torch.nan_to_num(img.to(torch.float32), nan=0.0).clamp(-1, 256)
    v = img.to(torch.int64)
    return v, (v >= 0) & (v < 256)


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) image -> (..., 256) i32 counts of int32(v) in [0,
    256)."""
    _check_image(img)
    batch_shape = img.shape[:-2]
    v, ok = _bins(img.reshape(-1, img.shape[-2] * img.shape[-1]))
    b = v.shape[0]
    # one bincount for the whole batch: image b's values land in bins
    # [256 b, 256 b + 256); values out of range in bin 256 B, dropped
    offsets = 256 * torch.arange(b, device=img.device)[:, None]
    flat = v + offsets
    if ok is not None:
        flat = torch.where(ok, flat, 256 * b)
    counts = torch.bincount(flat.reshape(-1), minlength=256 * b + 1)
    return counts[:256 * b].to(torch.int32).reshape(*batch_shape, 256)


def apply_lut256(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """lut[v] for every pixel v of a (..., H, W) image, 0 where int32(v)
    is outside [0, 256), as float32 (the reference's result dtype; callers
    clip and cast)."""
    _check_image(img)
    v, ok = _bins(img)
    table = x64_off(lut).to(torch.float32)
    if ok is None:
        return table[v]
    return torch.where(ok, table[v.clamp(0, 255)], 0.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of (..., H, W) images to u8: out =
    round(cdf(v) * 255 / npixels), rounding half to even as
    ``jnp.round``; pixels out of [0, 256) become 0."""
    h, w = img.shape[-2:]
    cdf = torch.cumsum(histogram256(img), dim=-1, dtype=torch.int32)
    lut = torch.round(cdf.to(torch.float32) * (255.0 / (h * w))
                      ).clamp(0, 255)
    if img.ndim == 2:
        return apply_lut256(img, lut).to(torch.uint8)
    v, ok = _bins(img.reshape(-1, h * w))
    out = torch.gather(lut.reshape(-1, 256), 1, v.clamp(0, 255))
    if ok is not None:
        out = torch.where(ok, out, 0.0)
    return out.reshape(img.shape).to(torch.uint8)


def projection_x(img: torch.Tensor) -> torch.Tensor:
    """Column sums of int32(v), int32 (wrapping)."""
    return _int32(img).sum(dim=-2, dtype=torch.int32)


def projection_y(img: torch.Tensor) -> torch.Tensor:
    """Row sums of int32(v), int32 (wrapping)."""
    return _int32(img).sum(dim=-1, dtype=torch.int32)


def _int32(img: torch.Tensor) -> torch.Tensor:
    """``astype(int32)``: a uint32 pixel wraps, as XLA converts it."""
    if img.dtype == torch.uint32:
        v = img.to(torch.int64)
        return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
    return img.to(torch.int32)
