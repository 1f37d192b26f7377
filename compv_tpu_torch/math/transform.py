"""Geometric transforms on homogeneous point sets (mirror of
``compv_tpu/math/transform.py``): perspective2D = 3x3 x 3xN, then the
homogeneous divide (compv_math_transform.h:19-20). Batched over leading
axes of the matrix."""
from __future__ import annotations

import torch

__all__ = ["to_homogeneous", "homogeneous_to_cartesian_2d", "perspective_2d",
           "apply_homography"]


def to_homogeneous(pts_xy: torch.Tensor) -> torch.Tensor:
    """(N, 2) -> (3, N)."""
    ones = torch.ones((1, pts_xy.shape[0]), dtype=pts_xy.dtype,
                      device=pts_xy.device)
    return torch.cat([pts_xy.T, ones], dim=0)


def homogeneous_to_cartesian_2d(pts_h: torch.Tensor) -> torch.Tensor:
    """(..., 3, N) -> (..., 2, N), dividing by the w row (guarding w ~ 0)."""
    w = pts_h[..., 2:3, :]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return pts_h[..., :2, :] / w


def perspective_2d(pts_h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(3, N) points, (..., 3, 3) matrix -> (..., 2, N) cartesian."""
    return homogeneous_to_cartesian_2d(m @ pts_h)


def apply_homography(h: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) H, (N, 2) points -> (..., N, 2)."""
    return perspective_2d(to_homogeneous(pts_xy), h).transpose(-1, -2)
