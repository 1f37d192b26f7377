"""Geometric transforms on homogeneous point sets (mirror of
``compv_tpu/math/transform.py``): perspective2D = 3x3 x 3xN, then the
homogeneous divide (compv_math_transform.h:19-20). Batched over leading
axes of the matrix. Every entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``); integer points against a float matrix are
float32, as ``jnp``'s promotion makes them.
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import at_x64_off, float_points
from compv_tpu_torch.math.ops import _matmul

__all__ = ["to_homogeneous", "homogeneous_to_cartesian_2d", "perspective_2d",
           "apply_homography"]


@at_x64_off
def to_homogeneous(pts_xy: torch.Tensor) -> torch.Tensor:
    """(N, 2) -> (3, N)."""
    ones = torch.ones((1, pts_xy.shape[0]), dtype=pts_xy.dtype,
                      device=pts_xy.device)
    return torch.cat([pts_xy.T, ones], dim=0)


@at_x64_off
def homogeneous_to_cartesian_2d(pts_h: torch.Tensor) -> torch.Tensor:
    """(..., 3, N) -> (..., 2, N), dividing by the w row (guarding w ~ 0)."""
    w = pts_h[..., 2:3, :]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return pts_h[..., :2, :] / w


@at_x64_off
def perspective_2d(pts_h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(3, N) points, (..., 3, 3) matrix -> (..., 2, N) cartesian."""
    if m.dtype.is_floating_point or pts_h.dtype.is_floating_point:
        m, pts_h = float_points(m), float_points(pts_h)
    return homogeneous_to_cartesian_2d(_matmul(m, pts_h))


@at_x64_off
def apply_homography(h: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) H, (N, 2) points -> (..., N, 2)."""
    return perspective_2d(to_homogeneous(pts_xy), h).transpose(-1, -2)
