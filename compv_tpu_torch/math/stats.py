"""Point-set statistics used by robust estimation (mirror of
``compv_tpu/math/stats.py``): Hartley normalization over masked point sets
(compv_math_stats.cxx normalize2D_hartley), masked mean and variance, and
the masked 2-D mean squared error."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hartley_normalize", "mse_2d", "masked_mean", "masked_variance"]

_SQRT2 = float(np.sqrt(np.float32(2.0)))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None):
    m = mask.to(x.dtype)
    if axis is None:
        return (x * m).sum() / m.sum().clamp_min(1e-9)
    return (x * m).sum(dim=axis) / m.sum(dim=axis).clamp_min(1e-9)


def masked_variance(x: torch.Tensor, mask: torch.Tensor, axis=None):
    mu = masked_mean(x, mask, axis)
    if axis is not None:
        mu = mu.unsqueeze(axis)
    return masked_mean((x - mu) ** 2, mask, axis)


def hartley_normalize(pts_xy: torch.Tensor, mask: torch.Tensor):
    """Translate the centroid to the origin and scale so the mean distance
    is sqrt(2).

    pts_xy (..., N, 2), mask (..., N) -> (normalized (..., N, 2), T
    (..., 3, 3) with x_norm_h = T @ x_h); leading dimensions are a batch of
    point sets."""
    m = mask.to(pts_xy.dtype)[..., None]
    n = m.sum(dim=(-2, -1)).clamp_min(1.0)
    centroid = (pts_xy * m).sum(dim=-2) / n[..., None]
    centered = (pts_xy - centroid[..., None, :]) * m
    dist = (centered ** 2).sum(dim=-1).sqrt()
    mean_dist = dist.sum(dim=-1) / n
    s = _SQRT2 / mean_dist.clamp_min(1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * centroid[..., 0]], -1),
                     torch.stack([zero, s, -s * centroid[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return centered * s[..., None, None], t


def mse_2d(a_xy: torch.Tensor, b_xy: torch.Tensor, mask: torch.Tensor
           ) -> torch.Tensor:
    """Masked mean squared error between two (N, 2) point sets."""
    e = ((a_xy - b_xy) ** 2).sum(dim=1)
    return masked_mean(e, mask)
