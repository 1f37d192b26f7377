"""Zhang camera calibration (mirror of ``compv_tpu/calib/camera.py``;
reference CompVCalibCamera, core/calib/compv_core_calib_camera.cxx:
per-plane homographies (:1002), the V constraint matrix and its smallest
eigenvector, closed-form K (Burger Alg. 4.4 / Zhang A.4, :531-560), per-view
R|t from H and K, radial k1, k2 by linear least squares, then
Levenberg-Marquardt over everything (:1028-1168)). Corner finding is in
``calib/checkerboard.py``.

Every plane is handled in one batch: the DLT under ``torch.func.vmap``,
K^-1 h, the SVD re-orthonormalization and the projections with a leading
plane axis. K is built with ``torch.stack`` (forward-mode AD carries it;
in-place indexing would not), and the acceptance of the LM result is a
select, so nothing waits on the device.

Signs: the eigenvector b is normalized to b0 > 0 as in the reference, and
the rotation's U is multiplied by the sign of det(U Vt); what comes out
does not depend on the sign the solver returns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from compv_tpu_torch.calib.homography import compute_homography_dlt
from compv_tpu_torch.calib.lm import LMConfig, levenberg_marquardt
from compv_tpu_torch.calib.utils import project_points_dist
from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.math.rotation import (matrix_to_rodrigues,
                                           rodrigues_to_matrix)

__all__ = ["CalibrationConfig", "CalibrationResult", "calibrate_camera",
           "intrinsics_from_homographies", "extrinsics_from_homography",
           "checkerboard_object_points"]


@dataclass(frozen=True)
class CalibrationConfig:
    with_tangential: bool = False   # p1, p2
    with_skew: bool = False         # gamma
    lm_iterations: int = 40


class CalibrationResult(NamedTuple):
    k: torch.Tensor             # (3, 3) intrinsics
    dist: torch.Tensor          # (4,) k1, k2, p1, p2
    rvecs: torch.Tensor         # (P, 3) per-plane rotations
    tvecs: torch.Tensor         # (P, 3)
    rms_initial: torch.Tensor   # closed-form reprojection RMS
    rms: torch.Tensor           # post-LM reprojection RMS


def checkerboard_object_points(rows: int, cols: int, square: float,
                               device=None) -> torch.Tensor:
    """(rows*cols, 3) planar grid, z = 0, row-major: the calibration
    pattern's model. On the card unless ``device`` says otherwise."""
    dev = require_cuda() if device is None else torch.device(device)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float64)
    pts = np.stack([xx * square, yy * square, np.zeros_like(xx)], -1)
    return torch.as_tensor(pts.reshape(-1, 3), dtype=torch.float32,
                           device=dev)


def _v_row(h: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Zhang's constraint vectors v_ij of (P, 3, 3) homographies -> (P, 6)
    (calib_camera.cxx:492-527)."""
    hi = h[..., :, i]
    hj = h[..., :, j]
    return torch.stack([
        hi[..., 0] * hj[..., 0],
        hi[..., 0] * hj[..., 1] + hi[..., 1] * hj[..., 0],
        hi[..., 1] * hj[..., 1],
        hi[..., 2] * hj[..., 0] + hi[..., 0] * hj[..., 2],
        hi[..., 2] * hj[..., 1] + hi[..., 1] * hj[..., 2],
        hi[..., 2] * hj[..., 2],
    ], dim=-1)


def _k_matrix(fx, fy, cx, cy, skew) -> torch.Tensor:
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([torch.stack([fx, skew, cx]),
                        torch.stack([zero, fy, cy]),
                        torch.stack([zero, zero, one])])


def intrinsics_from_homographies(hs: torch.Tensor) -> torch.Tensor:
    """(P, 3, 3) homographies -> (3, 3) K in closed form (Burger Alg. 4.4);
    P >= 3 (or >= 2 with zero skew)."""
    v = torch.stack([_v_row(hs, 0, 1),
                     _v_row(hs, 0, 0) - _v_row(hs, 1, 1)], dim=1)
    v = v.reshape(-1, 6)                                   # (2P, 6)
    _, vecs = torch.linalg.eigh(v.T @ v)
    b = vecs[:, 0]
    # sign so that b0 > 0 (B is positive definite up to scale)
    b = b * torch.sign(b[0] + 1e-30)
    b0, b1, b2, b3, b4, b5 = b.unbind()
    den = b0 * b2 - b1 * b1
    v0 = (b1 * b3 - b0 * b4) / den
    lam = b5 - (b3 * b3 + v0 * (b1 * b3 - b0 * b4)) / b0
    alpha = (lam / b0).abs().sqrt()
    beta = (lam * b0 / den).abs().sqrt()
    gamma = -b1 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b3 * alpha * alpha / lam
    return _k_matrix(alpha, beta, u0, v0, gamma)


def extrinsics_from_homography(h: torch.Tensor, k: torch.Tensor):
    """R|t of a plane from its homography, for (..., 3, 3) H: r1 = lam
    K^-1 h1, r2 = lam K^-1 h2, r3 = r1 x r2, t = lam K^-1 h3, R
    re-orthonormalized by SVD with det(R) = +1."""
    kinv = torch.linalg.inv(k)
    hk = kinv @ h                       # columns K^-1 h1, K^-1 h2, K^-1 h3
    h1, h2, h3 = hk[..., :, 0], hk[..., :, 1], hk[..., :, 2]
    lam = 1.0 / torch.linalg.vector_norm(h1, dim=-1).clamp_min(1e-12)
    # positive depth: t_z > 0
    lam = lam * torch.sign(h3[..., 2] * lam + 1e-30)
    r1 = lam[..., None] * h1
    r2 = lam[..., None] * h2
    r = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    u, _, vt = torch.linalg.svd(r)
    d = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :2], u[..., 2:] * torch.sign(d)[..., None, None]],
                  dim=-1)
    return u @ vt, lam[..., None] * h3


def _radial_lsq(obj_pts, img_pts, k, rvecs, tvecs):
    """k1, k2 by linear least squares (calib_camera.cxx radial LSQ):
    observed - ideal = (ideal - c) * (k1 r^2 + k2 r^4). The rows are the
    reference's: per plane its N u rows, then its N v rows."""
    fx, cx = k[0, 0], k[0, 2]
    fy, cy = k[1, 1], k[1, 2]
    pc = obj_pts @ rodrigues_to_matrix(rvecs).transpose(-1, -2) \
        + tvecs[:, None, :]
    xn = pc[..., 0] / pc[..., 2]
    yn = pc[..., 1] / pc[..., 2]
    r2 = xn * xn + yn * yn
    u_ideal = fx * xn + cx
    v_ideal = fy * yn + cy
    du = u_ideal - cx
    dv = v_ideal - cy
    a = torch.stack([torch.stack([du * r2, du * r2 * r2], -1),
                     torch.stack([dv * r2, dv * r2 * r2], -1)], dim=1)
    b = torch.stack([img_pts[..., 0] - u_ideal, img_pts[..., 1] - v_ideal],
                    dim=1)
    return torch.linalg.lstsq(a.reshape(-1, 2), b.reshape(-1, 1)
                              ).solution[:, 0]


def _unpack(x: torch.Tensor, p: int, config: CalibrationConfig):
    """The LM vector [fx, fy, cx, cy, (skew), k1, k2, (p1, p2), rvecs,
    tvecs] -> K, (k1, k2, p1, p2), (P, 3) rvecs, (P, 3) tvecs."""
    i = 4
    fx, fy, cx, cy = x[0], x[1], x[2], x[3]
    skew = torch.zeros_like(fx)
    if config.with_skew:
        skew = x[i]
        i += 1
    k1, k2 = x[i], x[i + 1]
    i += 2
    p1 = p2 = torch.zeros_like(fx)
    if config.with_tangential:
        p1, p2 = x[i], x[i + 1]
        i += 2
    rv = x[i:i + 3 * p].reshape(p, 3)
    tv = x[i + 3 * p:].reshape(p, 3)
    return (_k_matrix(fx, fy, cx, cy, skew), torch.stack([k1, k2, p1, p2]),
            rv, tv)


def _calibration_residual(x: torch.Tensor, obj_pts: torch.Tensor,
                          img_pts: torch.Tensor,
                          config: CalibrationConfig) -> torch.Tensor:
    """LM's residual: every plane's reprojection minus its corners, flat."""
    kmat, dist, rv, tv = _unpack(x, img_pts.shape[0], config)
    return (project_points_dist(obj_pts, kmat, dist, rv, tv)
            - img_pts).reshape(-1)


def calibrate_camera(obj_pts: torch.Tensor, img_pts: torch.Tensor,
                     config: CalibrationConfig = CalibrationConfig()
                     ) -> CalibrationResult:
    """The Zhang pipeline. obj_pts: (N, 3) planar model points (z = 0),
    shared by all planes; img_pts: (P, N, 2) corners per plane, P >= 3."""
    p, n, _ = img_pts.shape
    obj_pts = obj_pts.to(torch.float32)
    img_pts = img_pts.to(torch.float32)

    # 1) per-plane homographies (model plane -> image)
    src = obj_pts[:, :2]
    hs = torch.func.vmap(lambda d: compute_homography_dlt(src, d))(img_pts)

    # 2) closed-form intrinsics, 3) per-plane extrinsics
    k = intrinsics_from_homographies(hs)
    r, tvecs = extrinsics_from_homography(hs, k)
    rvecs = matrix_to_rodrigues(r)

    # 4) radial distortion
    dist0 = torch.cat([_radial_lsq(obj_pts, img_pts, k, rvecs, tvecs),
                       obj_pts.new_zeros(2)])

    def rms_of(kmat, dist, rv, tv):
        proj = project_points_dist(obj_pts, kmat, dist, rv, tv)
        return (((proj - img_pts) ** 2).sum() / (p * n)).sqrt()

    rms0 = rms_of(k, dist0, rvecs, tvecs)

    # 5) LM over [fx, fy, cx, cy, (skew), k1, k2, (p1, p2), rvecs, tvecs]
    base = [k[0, 0], k[1, 1], k[0, 2], k[1, 2]]
    if config.with_skew:
        base.append(k[0, 1])
    base += [dist0[0], dist0[1]]
    if config.with_tangential:
        base += [dist0[2], dist0[3]]
    x0 = torch.cat([torch.stack(base), rvecs.reshape(-1), tvecs.reshape(-1)])

    def residual(x):
        return _calibration_residual(x, obj_pts, img_pts, config)

    lm = levenberg_marquardt(residual, x0,
                             LMConfig(iterations=config.lm_iterations))
    k_f, dist_f, rv_f, tv_f = _unpack(lm.params, p, config)
    rms1 = rms_of(k_f, dist_f, rv_f, tv_f)

    # acceptance: the reprojection error must not rise after LM
    # (calib_camera.cxx:758-768)
    better = rms1 <= rms0
    return CalibrationResult(k=torch.where(better, k_f, k),
                             dist=torch.where(better, dist_f, dist0),
                             rvecs=torch.where(better, rv_f, rvecs),
                             tvecs=torch.where(better, tv_f, tvecs),
                             rms_initial=rms0,
                             rms=torch.minimum(rms0, rms1))
