"""Calibration utilities: projection with distortion, reprojection error,
undistortion (mirror of ``compv_tpu/calib/utils.py``; reference
compv_core_calib_utils.h:18-26: proj2D, proj2DError, initUndistMap +
undist2DImage, dist2DPoints).

``project_points_dist`` takes leading batch dimensions on the pose, so one
call projects the model points into every view.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.image.remap import remap_bilinear
from compv_tpu_torch.math.rotation import rodrigues_to_matrix

__all__ = ["project_points_dist", "distort_normalized", "reproj_error_rms",
           "build_undistort_map", "undistort_image", "undistort_points"]


@at_x64_off(floats=("xn", "yn", "dist"))
def distort_normalized(xn: torch.Tensor, yn: torch.Tensor,
                       dist: torch.Tensor):
    """Radial (k1, k2) and tangential (p1, p2) distortion of normalized
    camera coordinates; dist = (k1, k2, p1, p2)."""
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    # constants as tensors of the input's type: under forward-mode AD a
    # 0-d tensor combined with a Python float comes out float64
    one, two = xn.new_tensor(1.0), xn.new_tensor(2.0)
    r2 = xn * xn + yn * yn
    radial = one + k1 * r2 + k2 * r2 * r2
    xd = xn * radial + two * p1 * xn * yn + p2 * (r2 + two * xn * xn)
    yd = yn * radial + p1 * (r2 + two * yn * yn) + two * p2 * xn * yn
    return xd, yd


@at_x64_off(floats=("pts3d", "k", "dist", "rvec", "tvec"))
def project_points_dist(pts3d: torch.Tensor, k: torch.Tensor,
                        dist: torch.Tensor, rvec: torch.Tensor,
                        tvec: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points -> (..., N, 2) pixels through R|t (rvec, tvec
    (..., 3)), the distortion and K (proj2D,
    compv_core_calib_utils.cxx:227)."""
    r = rodrigues_to_matrix(rvec)
    pc = pts3d @ r.transpose(-1, -2) + tvec[..., None, :]
    zc = pc[..., 2]
    z = torch.where(zc.abs() < 1e-9, zc.new_tensor(1e-9), zc)
    xd, yd = distort_normalized(pc[..., 0] / z, pc[..., 1] / z, dist)
    u = k[0, 0] * xd + k[0, 1] * yd + k[0, 2]
    v = k[1, 1] * yd + k[1, 2]
    return torch.stack([u, v], dim=-1)


@at_x64_off(floats=("observed", "projected"))
def reproj_error_rms(observed: torch.Tensor, projected: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """RMS reprojection error (proj2DError)."""
    d2 = ((observed - projected) ** 2).sum(dim=-1)
    if mask is not None:
        n = mask.sum().clamp_min(1)
        return (torch.where(mask, d2, 0.0).sum() / n).sqrt()
    return d2.mean().sqrt()


@at_x64_off(floats=("k", "dist"))
def build_undistort_map(k: torch.Tensor, dist: torch.Tensor, height: int,
                        width: int):
    """For each undistorted output pixel, where to sample the distorted
    source (initUndistMap, compv_core_calib_utils.cxx:363): the forward
    distortion, in closed form."""
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=k.device),
        torch.arange(width, dtype=torch.float32, device=k.device),
        indexing="ij")
    fx, skew, cx = k[0, 0], k[0, 1], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    yn = (yy - cy) / fy
    xn = (xx - cx - skew * yn) / fx
    xd, yd = distort_normalized(xn, yn, dist)
    return fx * xd + skew * yd + cx, fy * yd + cy


@at_x64_off(floats=("k", "dist"))
def undistort_image(img: torch.Tensor, k: torch.Tensor, dist: torch.Tensor
                    ) -> torch.Tensor:
    """undist2DImage: the undistortion map, then a bilinear remap."""
    h, w = img.shape[:2]
    mx, my = build_undistort_map(k, dist, h, w)
    return remap_bilinear(img, mx, my)


@at_x64_off(floats=("pts", "k", "dist"))
def undistort_points(pts: torch.Tensor, k: torch.Tensor, dist: torch.Tensor,
                     iterations: int = 8) -> torch.Tensor:
    """Invert the distortion of (N, 2) pixel points by ``iterations``
    fixed-point steps."""
    fx, skew, cx = k[0, 0], k[0, 1], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    yd = (pts[:, 1] - cy) / fy
    xd = (pts[:, 0] - cx - skew * yd) / fx
    xn, yn = xd, yd
    for _ in range(iterations):
        xdd, ydd = distort_normalized(xn, yn, dist)
        xn, yn = xn + (xd - xdd), yn + (yd - ydd)
    return torch.stack([fx * xn + skew * yn + cx, fy * yn + cy], dim=1)
