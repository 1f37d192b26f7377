"""256-bin histogram (mirror of ``compv_tpu/image/histogram.py:histogram256``).

The reference builds the histogram from a one-hot nibble matmul, a device
for the TPU's matrix unit; its counts are exact integers, and so are
``torch.bincount``'s, on every device.
"""
from __future__ import annotations

import torch

__all__ = ["histogram256"]


def histogram256(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) u8 -> (..., 256) i32 counts."""
    if img.dtype != torch.uint8 or img.ndim < 2:
        raise ValueError(f"expected a (..., H, W) uint8 image, got "
                         f"{img.ndim}-D {img.dtype}")
    batch_shape = img.shape[:-2]
    flat = img.reshape(-1, img.shape[-2] * img.shape[-1]).to(torch.int64)
    # one bincount for the whole batch: image b's values land in bins
    # [256 b, 256 b + 256)
    offsets = 256 * torch.arange(flat.shape[0], device=img.device)[:, None]
    counts = torch.bincount((flat + offsets).reshape(-1),
                            minlength=256 * flat.shape[0])
    return counts.to(torch.int32).reshape(*batch_shape, 256)
