"""Histogram ops: 256-bin counts, LUT application, equalization, axis
projections (mirror of ``compv_tpu/image/histogram.py``; reference
CompVMathHistogram, base/math/compv_math_histogram.cxx).

The reference builds the histogram and applies a LUT through one-hot
nibble matmuls, a device for the TPU's matrix unit. Both compute exact
functions: integer counts, and one table entry per pixel (a dot product
with a single nonzero term). ``torch.bincount`` and a gather
(``lut[img]``) compute the same values on every device.
"""
from __future__ import annotations

import torch

__all__ = ["histogram256", "equalize", "apply_lut256", "projection_x",
           "projection_y"]


def _check_u8(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8 or img.ndim < 2:
        raise ValueError(f"expected a (..., H, W) uint8 image, got "
                         f"{img.ndim}-D {img.dtype}")


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) u8 -> (..., 256) i32 counts."""
    _check_u8(img)
    batch_shape = img.shape[:-2]
    flat = img.reshape(-1, img.shape[-2] * img.shape[-1]).to(torch.int64)
    # one bincount for the whole batch: image b's values land in bins
    # [256 b, 256 b + 256)
    offsets = 256 * torch.arange(flat.shape[0], device=img.device)[:, None]
    counts = torch.bincount((flat + offsets).reshape(-1),
                            minlength=256 * flat.shape[0])
    return counts.to(torch.int32).reshape(*batch_shape, 256)


def apply_lut256(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """lut[v] for every pixel v of a (..., H, W) u8 image, as float32 (the
    reference's result dtype; callers clip and cast)."""
    _check_u8(img)
    return lut.to(torch.float32)[img.to(torch.int64)]


def equalize(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of u8 images (..., H, W): out =
    round(cdf(v) * 255 / npixels), rounding half to even as
    ``jnp.round``."""
    h, w = img.shape[-2:]
    cdf = torch.cumsum(histogram256(img), dim=-1, dtype=torch.int32)
    lut = torch.round(cdf.to(torch.float32) * (255.0 / (h * w))
                      ).clamp(0, 255)
    if img.ndim == 2:
        return apply_lut256(img, lut).to(torch.uint8)
    flat = img.reshape(-1, h * w).to(torch.int64)
    out = torch.gather(lut.reshape(-1, 256), 1, flat)
    return out.reshape(img.shape).to(torch.uint8)


def projection_x(img: torch.Tensor) -> torch.Tensor:
    """Column sums, int32."""
    return img.to(torch.int32).sum(dim=-2, dtype=torch.int32)


def projection_y(img: torch.Tensor) -> torch.Tensor:
    """Row sums, int32."""
    return img.to(torch.int32).sum(dim=-1, dtype=torch.int32)
