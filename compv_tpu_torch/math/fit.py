"""Robust curve fitting: line and parabola by RANSAC, then a least-squares
refinement on the inliers (mirror of ``compv_tpu/math/fit.py``; reference
CompVMathStatsFit, base/math/compv_math_stats_fit.cxx).

The line's refinement is a total least squares fit whose normal is the
smallest eigenvector of the inliers' 2 x 2 covariance; its sign is the
solver's (LAPACK, cuSOLVER and XLA may each return either), so (a, b, c)
is defined up to sign, as in the reference. The parabola's is a
least-squares solve of the inliers' Vandermonde system (full rank and
tall, which the card's only ``lstsq`` driver, ``gels``, needs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from compv_tpu_torch.calib.ransac import RansacConfig, ransac
from compv_tpu_torch.math.distance import dist_line, dist_parabola

__all__ = ["LineFit", "ParabolaFit", "fit_line", "fit_parabola"]


class LineFit(NamedTuple):
    abc: torch.Tensor        # (3,) ax + by + c = 0, |(a, b)| = 1
    inliers: torch.Tensor
    num_inliers: torch.Tensor


class ParabolaFit(NamedTuple):
    abc: torch.Tensor        # y = a x^2 + b x + c (x = f(y) for axis "y")
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _tls_line(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Total least squares line through the masked points."""
    m = mask.to(pts.dtype)[:, None]
    n = m.sum().clamp_min(1.0)
    mu = (pts * m).sum(dim=0) / n
    d = (pts - mu) * m
    _, vecs = torch.linalg.eigh(d.T @ d)
    normal = vecs[:, 0]
    return torch.cat([normal, -(normal * mu).sum()[None]])


def _line_through(sub: torch.Tensor) -> torch.Tensor:
    p, q = sub[0], sub[1]
    d = q - p
    nv = torch.stack([-d[1], d[0]])
    nv = nv / torch.linalg.vector_norm(nv).clamp_min(1e-12)
    return torch.cat([nv, -(nv * p).sum()[None]])


def _line_residuals(model: torch.Tensor, points: torch.Tensor
                    ) -> torch.Tensor:
    return dist_line(points, model[0], model[1], model[2])


def fit_line(pts: torch.Tensor, mask: torch.Tensor | None = None,
             threshold: float = 1.0, num_hypotheses: int = 256,
             seed: int = 0) -> LineFit:
    """Robust line fit (CompVMathStatsFit::line)."""
    if mask is None:
        mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                          device=pts.device)
    r = ransac(pts, _line_through, _line_residuals, mask,
               RansacConfig(num_hypotheses=num_hypotheses, min_model_points=2,
                            threshold=threshold, seed=seed))
    refined = _tls_line(pts, r.inliers)
    inl = (dist_line(pts, refined[0], refined[1], refined[2])
           < threshold) & mask
    better = inl.sum() >= r.num_inliers
    model = torch.where(better, refined, r.model)
    inliers = torch.where(better, inl, r.inliers)
    return LineFit(abc=model, inliers=inliers,
                   num_inliers=inliers.sum().to(torch.int32))


def _parabola_through(sub: torch.Tensor) -> torch.Tensor:
    """The parabola through 3 points (Vandermonde solve). Two samples
    with one x make it singular: ``solve_ex`` returns a non-finite model
    there (no raise, no read of ``info``), and ransac's finiteness guard
    drops the hypothesis, as the reference's ``jnp.linalg.solve`` does."""
    x, y = sub[:, 0], sub[:, 1]
    v = torch.stack([x * x, x, torch.ones_like(x)], dim=1)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return torch.linalg.solve_ex(v + 1e-12 * eye, y).result


def _parabola_residuals(model: torch.Tensor, points: torch.Tensor
                        ) -> torch.Tensor:
    return dist_parabola(points, model[0], model[1], model[2])


def fit_parabola(pts: torch.Tensor, mask: torch.Tensor | None = None,
                 threshold: float = 1.0, num_hypotheses: int = 256,
                 axis: str = "x", seed: int = 0) -> ParabolaFit:
    """Robust parabola fit (CompVMathStatsFit::parabola)."""
    if mask is None:
        mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                          device=pts.device)
    pts_f = pts.flip(1) if axis == "y" else pts
    r = ransac(pts_f, _parabola_through, _parabola_residuals, mask,
               RansacConfig(num_hypotheses=num_hypotheses, min_model_points=3,
                            threshold=threshold, seed=seed))
    m = r.inliers.to(pts_f.dtype)
    x, y = pts_f[:, 0], pts_f[:, 1]
    v = torch.stack([x * x, x, torch.ones_like(x)], dim=1) * m[:, None]
    sol = torch.linalg.lstsq(v, (y * m)[:, None]).solution[:, 0]
    inl = (dist_parabola(pts_f, sol[0], sol[1], sol[2]) < threshold) & mask
    better = inl.sum() >= r.num_inliers
    model = torch.where(better, sol, r.model)
    inliers = torch.where(better, inl, r.inliers)
    return ParabolaFit(abc=model, inliers=inliers,
                       num_inliers=inliers.sum().to(torch.int32))
