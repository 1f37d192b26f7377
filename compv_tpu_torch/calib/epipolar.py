"""Epipolar geometry (mirror of ``compv_tpu/calib/epipolar.py``):
essential / fundamental matrix estimation, pose recovery, triangulation.

RANSAC as in ``calib/homography.py``: all 8-point hypotheses are solved at
once (one batched 9x9 ``eigh`` and batched 3x3 SVDs over a leading
hypothesis axis, where the reference vmaps), scored with the Sampson error
as one batched product. The samples are the reference's
``jax.random.randint`` stream (``ops/threefry.randint``), so hypothesis i
uses the same 8 points in both packages.

Eigen- and singular vectors are defined up to sign, and cuSOLVER, LAPACK
and XLA may pick different ones: E, the Sampson error and the
triangulated points do not depend on it, and ``decompose_essential`` makes
U and V^T proper rotations before it builds its candidates.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.math.stats import hartley_normalize
from compv_tpu_torch.ops import threefry
from compv_tpu_torch.math.rotation import matrix_to_rodrigues

__all__ = ["EssentialConfig", "EssentialResult", "compute_fundamental_8pt",
           "find_essential", "decompose_essential", "triangulate_points",
           "sampson_error"]


@dataclass(frozen=True)
class EssentialConfig:
    num_hypotheses: int = 512
    threshold: float = 1e-5      # squared Sampson error in normalized coords
                                 # (~1.6 px at f=500)
    seed: int = 0


class EssentialResult(NamedTuple):
    e: torch.Tensor            # (3,3) essential matrix
    inliers: torch.Tensor      # (N,)
    num_inliers: torch.Tensor
    rvec: torch.Tensor         # (3,) relative rotation (cam1 -> cam2)
    tvec: torch.Tensor         # (3,) unit-norm translation
    points3d: torch.Tensor     # (N,3) triangulated (in cam1 frame)


def _eight_point(src: torch.Tensor, dst: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized 8-point algorithm: (..., N, 2) point sets -> (..., 3, 3)
    F (E in normalized camera coordinates), rank 2."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=torch.bool,
                          device=src.device)
    s_n, t_s = hartley_normalize(src, mask)
    d_n, t_d = hartley_normalize(dst, mask)
    x1, y1 = s_n[..., 0], s_n[..., 1]
    x2, y2 = d_n[..., 0], d_n[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    a = a * mask.to(a.dtype)[..., None]
    _, vecs = torch.linalg.eigh(a.mT @ a)
    f = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    u, s, vt = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    f = (u * s[..., None, :]) @ vt
    return t_d.mT @ f @ t_s


def compute_fundamental_8pt(src: torch.Tensor, dst: torch.Tensor,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    return _eight_point(src, dst, mask)


def _essential_from_f(f: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(f)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=f.dtype, device=f.device)
    return (u * d) @ vt


def sampson_error(e: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
                  ) -> torch.Tensor:
    """First-order geometric (Sampson) error per correspondence; ``e``
    (..., 3, 3) against (N, 2) points -> (..., N)."""
    ones = torch.ones((src.shape[0], 1), dtype=src.dtype, device=src.device)
    x1 = torch.cat([src, ones], dim=1)
    x2 = torch.cat([dst, ones], dim=1)
    ex1 = x1 @ e.mT
    etx2 = x2 @ e
    num = (x2 * ex1).sum(dim=-1) ** 2
    den = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2
           + etx2[..., 1] ** 2)
    return num / den.clamp_min(1e-18)


def triangulate_points(r: torch.Tensor, t: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation in normalized coords, cam1 = [I|0], cam2
    = [R|t]: (N, 2) + (N, 2) -> (N, 3) in cam1's frame. ``r`` (..., 3, 3)
    and ``t`` (..., 3) may carry a batch of poses: (..., N, 3)."""
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    p1 = torch.cat([eye, torch.zeros((3, 1), dtype=r.dtype,
                                     device=r.device)], dim=1)
    p2 = torch.cat([r, t[..., :, None]], dim=-1)[..., None, :, :]
    s, d = src[:, :, None], dst[:, :, None]
    a2 = d[:, 0] * p2[..., 2, :] - p2[..., 0, :]     # (..., N, 4)
    a3 = d[:, 1] * p2[..., 2, :] - p2[..., 1, :]
    a = torch.stack([(s[:, 0] * p1[2] - p1[0]).expand_as(a2),
                     (s[:, 1] * p1[2] - p1[1]).expand_as(a2), a2, a3],
                    dim=-2)                           # (..., N, 4, 4)
    _, vecs = torch.linalg.eigh(a.mT @ a)
    x = vecs[..., :, 0]
    w = torch.where(x[..., 3].abs() < 1e-12, x.new_tensor(1e-12), x[..., 3])
    return x[..., :3] / w[..., None]


def decompose_essential(e: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, mask: torch.Tensor):
    """E -> (R, t, points) with the cheirality test over the 4 candidates
    (most points in front of both cameras wins, the first on a tie).
    Coordinates must be normalized."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=e.dtype, device=e.device)
    r1 = u @ wm @ vt
    r2 = u @ wm.T @ vt
    tv = u[:, 2]
    rs = torch.stack([r1, r1, r2, r2])
    ts = torch.stack([tv, -tv, tv, -tv])
    pts = triangulate_points(rs, ts, src, dst)              # (4, N, 3)
    z2 = (pts @ rs.mT + ts[:, None, :])[..., 2]
    ok = (pts[..., 2] > 0) & (z2 > 0) & mask
    best = torch.argmax(ok.sum(dim=1))
    return rs[best], ts[best], pts[best]


def find_essential(src_px: torch.Tensor, dst_px: torch.Tensor,
                   k: torch.Tensor, mask: torch.Tensor | None = None,
                   config: EssentialConfig = EssentialConfig()
                   ) -> EssentialResult:
    """RANSAC essential matrix from pixel correspondences and intrinsics K:
    E, inliers, the recovered (R | t up to scale) and the triangulated
    points. Nothing waits on the device."""
    n = src_px.shape[0]
    dev = src_px.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    kinv = torch.linalg.inv_ex(k.to(torch.float32)).inverse

    def norm_pts(p):
        ph = torch.cat([p, torch.ones((n, 1), dtype=p.dtype, device=dev)], 1)
        q = ph @ kinv.T
        return q[:, :2] / q[:, 2:3]

    src = norm_pts(src_px.to(torch.float32))
    dst = norm_pts(dst_px.to(torch.float32))

    order = torch.argsort((~mask).to(torch.int32), stable=True)
    n_valid = mask.sum().to(torch.int32)
    ridx = threefry.randint(threefry.prng_key(config.seed),
                            (config.num_hypotheses, 8), 0,
                            n_valid.clamp_min(1), dev)
    idx = order[ridx.long()]

    es = _essential_from_f(_eight_point(src[idx], dst[idx]))   # (S, 3, 3)
    errs = sampson_error(es, src, dst)                         # (S, N)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)
    inl = (errs < config.threshold) & mask[None, :]
    best = torch.argmax(inl.sum(dim=1))
    e_best = es[best]
    inl_best = inl[best]

    # refine on all inliers
    e_ref = _essential_from_f(_eight_point(src, dst, inl_best))
    inl_ref = (sampson_error(e_ref, src, dst) < config.threshold) & mask
    better = inl_ref.sum() >= inl_best.sum()
    e_fin = torch.where(better, e_ref, e_best)
    inl_fin = torch.where(better, inl_ref, inl_best)

    r, t, pts = decompose_essential(e_fin, src, dst, inl_fin)
    return EssentialResult(e=e_fin, inliers=inl_fin,
                           num_inliers=inl_fin.sum().to(torch.int32),
                           rvec=matrix_to_rodrigues(r), tvec=t, points3d=pts)
