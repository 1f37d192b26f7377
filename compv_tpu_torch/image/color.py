"""Color conversion to gray (mirror of ``compv_tpu/image/color.py``).

Same fixed-point arithmetic as the reference, so u8 outputs are bit-exact:
Y = ((33R + 65G + 13B) >> 7) + 16 (compv_image_conv_common.cxx:29-31).
"""
from __future__ import annotations

import torch

__all__ = ["rgb_to_gray", "to_gray"]


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) u8 RGB -> (H,W) u8 luma."""
    c = rgb.to(torch.int32)
    y = ((33 * c[..., 0] + 65 * c[..., 1] + 13 * c[..., 2]) >> 7) + 16
    return y.clamp(0, 255).to(torch.uint8)


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """Any->gray facade: channel-last u8 in, (H,W) u8 out."""
    if img.ndim == 2:
        return img.to(torch.uint8)
    c = img.shape[-1]
    if c in (3, 4):
        return rgb_to_gray(img[..., :3])
    raise ValueError(f"unsupported channel count {c}")
