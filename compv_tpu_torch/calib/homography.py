"""Homography estimation: normalized DLT + batched-hypothesis RANSAC
(mirror of ``compv_tpu/calib/homography.py``).

All S hypotheses are evaluated at once: (S, 4) point subsets drawn from the
reference's threefry stream (``ops/threefry.py``, keyed by
``HomographyConfig.seed``), each 4-point system solved in closed form
(projective-basis construction), all S x N symmetric transfer errors scored
in one batch, the best hypothesis kept and refined by a normalized DLT on
its inliers (reference CompVHomography<T>::find,
compv_core_calib_homography.cxx:60). ``vmap`` becomes a leading batch axis.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.calib.ransac import _masked_sample_idx
from compv_tpu_torch.math.stats import hartley_normalize
from compv_tpu_torch.math.transform import apply_homography
from compv_tpu_torch.profiling import span

__all__ = ["HomographyConfig", "HomographyResult", "compute_homography_dlt",
           "find_homography", "symmetric_transfer_error"]


@dataclass(frozen=True)
class HomographyConfig:
    """Defaults per the reference (calib_homography.cxx:27-28, :203)."""
    num_hypotheses: int = 512
    threshold: float = 30.0       # squared-pixel symmetric transfer threshold
    seed: int = 0
    refine: bool = True           # final DLT on all inliers


class HomographyResult(NamedTuple):
    h: torch.Tensor            # (3, 3) f32, h22-normalized
    inliers: torch.Tensor      # (N,) bool
    num_inliers: torch.Tensor  # () i32


def _dlt_rows(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The 2N x 9 DLT system for H mapping src->dst
    (buildHomographyEqMatrix, compv_math_matrix.cxx:1051-1061)."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=1)
    return torch.cat([r1, r2], dim=0)


def _normalize_h22(h: torch.Tensor) -> torch.Tensor:
    h22 = h[..., 2:3, 2:3]
    return h / torch.where(h22.abs() < 1e-12, 1e-12, h22)


@at_x64_off(floats=("src", "dst"))
def compute_homography_dlt(src: torch.Tensor, dst: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT: (3,3) H with H[2,2]=1 mapping src->dst over the
    points selected by ``mask`` (masked rows are zeroed in the normal
    equations)."""
    if mask is None:
        mask = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    src_n, t_src = hartley_normalize(src, mask)
    dst_n, t_dst = hartley_normalize(dst, mask)
    a = _dlt_rows(src_n, dst_n) * torch.cat([mask, mask]).to(src.dtype)[:, None]
    _, vecs = torch.linalg.eigh(a.T @ a)        # ascending eigenvalues
    hn = vecs[:, 0].reshape(3, 3)               # smallest
    return _normalize_h22(torch.linalg.inv(t_dst) @ hn @ t_src)


def _inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, hh, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * hh
    cb = f * g - d * i
    cc = d * hh - e * g
    det = a * ca + b * cb + c * cc
    det = torch.where(det.abs() < 1e-20, torch.inf, det)
    adj = torch.stack([
        torch.stack([ca, c * hh - b * i, b * f - c * e], -1),
        torch.stack([cb, a * i - c * g, c * d - a * f], -1),
        torch.stack([cc, b * g - a * hh, a * e - b * d], -1),
    ], -2)
    return adj / det[..., None, None]


def _h_from_quad(src4: torch.Tensor, dst4: torch.Tensor) -> torch.Tensor:
    """Exact homographies through (..., 4, 2) point quads by the projective
    basis: A(q) = [q1 q2 q3] diag(inv([q1 q2 q3]) q4) maps the canonical
    basis onto q, so H = A(dst) A(src)^-1 — two closed-form 3x3 inverses.
    Each quad is similarity-normalized (centroid / RMS) first."""

    def norm(q):
        c = q.mean(dim=-2, keepdim=True)
        s = (((q - c) ** 2).sum(dim=-1).mean(dim=-1) + 1e-12).sqrt()
        return (q - c) / s[..., None, None], c[..., 0, :], s

    def basis(q):
        m = torch.stack([q[..., :3, 0], q[..., :3, 1],
                         torch.ones_like(q[..., :3, 0])], dim=-2)
        p4 = torch.stack([q[..., 3, 0], q[..., 3, 1],
                          torch.ones_like(q[..., 3, 0])], dim=-1)
        lam = (_inv3x3(m) @ p4[..., None])[..., 0]
        return m * lam[..., None, :]

    s_n, sc, ss = norm(src4)
    d_n, dc, ds = norm(dst4)
    hn = basis(d_n) @ _inv3x3(basis(s_n))
    # denormalize: H = T_dst^-1 @ Hn @ T_src, both similarities
    one, zero = torch.ones_like(ss), torch.zeros_like(ss)
    t_src = torch.stack([
        torch.stack([one, zero, -sc[..., 0]], -1),
        torch.stack([zero, one, -sc[..., 1]], -1),
        torch.stack([zero, zero, ss], -1)], -2) / ss[..., None, None]
    t_dst_inv = torch.stack([
        torch.stack([ds, zero, dc[..., 0]], -1),
        torch.stack([zero, ds, dc[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)
    return _normalize_h22(t_dst_inv @ hn @ t_src)


@at_x64_off(floats=("h", "src", "dst"))
def symmetric_transfer_error(h: torch.Tensor, src: torch.Tensor,
                             dst: torch.Tensor) -> torch.Tensor:
    """Per-point d(H src, dst)^2 + d(H^-1 dst, src)^2 for (..., 3, 3) H ->
    (..., N) (countInliers, calib_homography.cxx:498)."""
    fwd = apply_homography(h, src)
    eye = torch.eye(3, dtype=h.dtype, device=h.device)
    bwd = apply_homography(_inv3x3(h + 1e-12 * eye), dst)
    return ((fwd - dst) ** 2).sum(dim=-1) + ((bwd - src) ** 2).sum(dim=-1)


def _quad_nondegenerate(p4: torch.Tensor) -> torch.Tensor:
    """(..., 4, 2) -> (...,) True when no 3 of the 4 points are (nearly)
    colinear (calib_homography.cxx:188-246): scale-relative cross products
    over all 4 triples."""
    triples = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
    a = torch.stack([p4[..., j, :] - p4[..., i, :] for i, j, _ in triples], -2)
    b = torch.stack([p4[..., l, :] - p4[..., i, :] for i, _, l in triples], -2)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    scale = ((a * a).sum(dim=-1) + (b * b).sum(dim=-1)).clamp_min(1e-12)
    return (cross.abs() > 1e-5 * scale).all(dim=-1)


@at_x64_off(floats=("src", "dst"))
def find_homography(src: torch.Tensor, dst: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    config: HomographyConfig = HomographyConfig()
                    ) -> HomographyResult:
    """RANSAC homography over padded point sets (N, 2) + validity mask.
    Winner = most inliers, lower summed inlier error as tie-break."""
    with span("homography"):
        n = src.shape[0]
        if mask is None:
            mask = torch.ones((n,), dtype=torch.bool, device=src.device)
        src = src.to(torch.float32)
        dst = dst.to(torch.float32)

        idx = _masked_sample_idx(config.seed, mask, config.num_hypotheses, 4)
        s4, d4 = src[idx], dst[idx]                                # (S, 4, 2)
        hs = _h_from_quad(s4, d4)                                  # (S, 3, 3)
        hyp_ok = (_quad_nondegenerate(s4) & _quad_nondegenerate(d4)
                  & mask[idx].all(dim=1)
                  & torch.isfinite(hs).all(dim=2).all(dim=1))
        errs = symmetric_transfer_error(hs, src, dst)
        errs = torch.where(torch.isfinite(errs), errs, torch.inf)   # (S, N)
        inl = (errs < config.threshold) & mask[None, :] & hyp_ok[:, None]
        counts = inl.sum(dim=1)
        score = (counts.to(torch.float32)
                 - 1e-9 * torch.where(inl, errs, 0.0).sum(dim=1))
        score = torch.where(hyp_ok, score, -torch.inf)
        best = torch.argmax(score)
        best_h = hs[best]
        best_inl = inl[best]

        if config.refine:
            h_ref = compute_homography_dlt(src, dst, best_inl)
            inl_ref = (symmetric_transfer_error(h_ref, src, dst)
                       < config.threshold) & mask
            better = inl_ref.sum() >= best_inl.sum()
            best_h = torch.where(better, h_ref, best_h)
            best_inl = torch.where(better, inl_ref, best_inl)

        return HomographyResult(h=best_h, inliers=best_inl,
                                num_inliers=best_inl.sum().to(torch.int32))
