"""Perspective-n-Point: camera pose from 2D-3D correspondences (mirror of
``compv_tpu/calib/pnp.py``).

Every RANSAC hypothesis is a 6-point DLT (one batched 12x12 ``eigh`` over a
leading hypothesis axis, where the reference vmaps), drawn from the
reference's threefry stream (``calib.homography._masked_sample_idx``),
scored by one batched reprojection; the best is re-solved on its inliers
and polished by a few Gauss-Newton steps on (rvec, tvec), with
``torch.func.jacfwd`` over the 6 pose parameters where the reference uses
``jax.jacfwd``. Nothing waits on the device.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.calib.homography import _masked_sample_idx
from compv_tpu_torch.math.rotation import matrix_to_rodrigues, rodrigues_to_matrix

__all__ = ["PnpConfig", "PnpResult", "pnp_dlt", "solve_pnp"]


@dataclass(frozen=True)
class PnpConfig:
    num_hypotheses: int = 256
    sample_size: int = 6
    threshold: float = 2e-5     # squared reprojection error, normalized coords
                                # (~2.2 px at f=500)
    refine_iterations: int = 10
    seed: int = 0


class PnpResult(NamedTuple):
    rvec: torch.Tensor        # (3,) world -> camera rotation (rodrigues)
    tvec: torch.Tensor        # (3,)
    inliers: torch.Tensor     # (N,) bool
    num_inliers: torch.Tensor


def _camera_points(rvec, tvec, pts3d):
    """World points (N, 3) in the camera frame of (..., 3) poses:
    (..., N, 3)."""
    r = rodrigues_to_matrix(rvec)
    return pts3d @ r.mT + tvec[..., None, :]


def _project_norm(rvec: torch.Tensor, tvec: torch.Tensor,
                  pts3d: torch.Tensor) -> torch.Tensor:
    """World points -> normalized image coords (..., N, 2)."""
    pc = _camera_points(rvec, tvec, pts3d)
    zc = pc[..., 2]
    z = torch.where(zc.abs() < 1e-9, zc.new_tensor(1e-9), zc)
    return pc[..., :2] / z[..., None]


@at_x64_off(floats=("pts3d", "pts2d_norm"))
def pnp_dlt(pts3d: torch.Tensor, pts2d_norm: torch.Tensor,
            mask: torch.Tensor | None = None):
    """Direct linear transform PnP: (..., N, 3) world points and (..., N,
    2) NORMALIZED image coords -> (rvec, tvec), each (..., 3). Needs N >= 6
    non-coplanar points.

    P (3, 4) is the smallest eigenvector of the 2N x 12 system's normal
    matrix; its sign is fixed by det(P[:, :3]) (det = lambda^3, lambda > 0
    for points in front of the camera), M = P[:, :3] is projected onto
    SO(3) by an SVD and the scale recovered from its singular values.
    The 12 x 12 eigendecomposition is float32, as the reference's: on
    poorly spread points the card's solver and LAPACK can return null
    vectors far apart (the sweep's ``CARD_FAULTS``)."""
    if mask is None:
        mask = torch.ones(pts3d.shape[:-1], dtype=torch.bool,
                          device=pts3d.device)
    x = pts3d.to(torch.float32)
    u = pts2d_norm.to(torch.float32)
    xh = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)     # (.., N, 4)
    zero = torch.zeros_like(xh)
    row_u = torch.cat([xh, zero, -u[..., :1] * xh], dim=-1)       # (.., N, 12)
    row_v = torch.cat([zero, xh, -u[..., 1:2] * xh], dim=-1)
    a = torch.cat([row_u, row_v], dim=-2)                         # (.., 2N, 12)
    a = a * torch.cat([mask, mask], dim=-1).to(a.dtype)[..., None]
    _, vecs = torch.linalg.eigh(a.mT @ a)
    p = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 4)
    p = p * torch.sign(torch.linalg.det(p[..., :3]))[..., None, None]
    uu, s, vt = torch.linalg.svd(p[..., :3])
    r = uu @ vt
    scale = s.mean(dim=-1).clamp_min(1e-12)
    t = p[..., 3] / scale[..., None]
    return matrix_to_rodrigues(r), t


def _refine_gn(rvec, tvec, pts3d, pts2d, weights, iterations: int):
    """Fixed-iteration Gauss-Newton on the 6 pose parameters (a dense 6x6
    normal system, forward-mode Jacobian over the pose only); a step is
    kept only where it lowers the cost."""
    def resid(p6):
        pred = _project_norm(p6[:3], p6[3:], pts3d)
        return ((pred - pts2d) * weights[:, None]).reshape(-1)

    jac = torch.func.jacfwd(resid)
    eye = 1e-8 * torch.eye(6, dtype=rvec.dtype, device=rvec.device)
    p6 = torch.cat([rvec, tvec])
    for _ in range(iterations):
        r0 = resid(p6)
        j = jac(p6)                                      # (2N, 6)
        dp = torch.linalg.solve_ex(j.T @ j + eye, j.T @ r0).result
        p1 = p6 - dp
        better = (resid(p1) ** 2).sum() < (r0 ** 2).sum()
        p6 = torch.where(better, p1, p6)
    return p6[:3], p6[3:]


@at_x64_off(floats=("pts3d", "pts2d_px", "k"))
def solve_pnp(pts3d: torch.Tensor, pts2d_px: torch.Tensor, k: torch.Tensor,
              mask: torch.Tensor | None = None,
              config: PnpConfig = PnpConfig()) -> PnpResult:
    """RANSAC PnP from pixel observations and intrinsics K over padded
    point sets (N, 3) / (N, 2) with a validity mask."""
    n = pts3d.shape[0]
    dev = pts3d.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    kinv = torch.linalg.inv_ex(k.to(torch.float32)).inverse
    ph = torch.cat([pts2d_px.to(torch.float32),
                    torch.ones((n, 1), dtype=torch.float32, device=dev)], 1)
    q = ph @ kinv.T
    pn = q[:, :2] / q[:, 2:3]

    idx = _masked_sample_idx(config.seed, mask, config.num_hypotheses,
                             config.sample_size)
    rvs, tvs = pnp_dlt(pts3d[idx], pn[idx])
    samp_ok = mask[idx].all(dim=1)

    def score(rv, tv):
        pred = _project_norm(rv, tv, pts3d)
        z = _camera_points(rv, tv, pts3d)[..., 2]
        e = ((pred - pn) ** 2).sum(dim=-1)
        return torch.where(z > 0, e, torch.inf)

    errs = score(rvs, tvs)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)
    inl = (errs < config.threshold) & mask[None, :] & samp_ok[:, None]
    best = torch.argmax(inl.sum(dim=1))
    rvec, tvec, inl_b = rvs[best], tvs[best], inl[best]

    # re-solve the DLT on all inliers, keep it if not worse
    rv2, tv2 = pnp_dlt(pts3d, pn, inl_b)
    inl2 = (score(rv2, tv2) < config.threshold) & mask
    better = inl2.sum() >= inl_b.sum()
    rvec = torch.where(better, rv2, rvec)
    tvec = torch.where(better, tv2, tvec)
    inl_b = torch.where(better, inl2, inl_b)

    # GN polish on the inliers, kept only if the inlier set does not
    # shrink: pose and inliers revert together
    rv_p, tv_p = _refine_gn(rvec, tvec, pts3d, pn, inl_b.to(torch.float32),
                            config.refine_iterations)
    inl3 = (score(rv_p, tv_p) < config.threshold) & mask
    keep = inl3.sum() >= inl_b.sum()
    rvec = torch.where(keep, rv_p, rvec)
    tvec = torch.where(keep, tv_p, tvec)
    inl_b = torch.where(keep, inl3, inl_b)
    return PnpResult(rvec=rvec, tvec=tvec, inliers=inl_b,
                     num_inliers=inl_b.sum().to(torch.int32))
