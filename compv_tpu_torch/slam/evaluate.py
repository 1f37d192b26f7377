"""Trajectory evaluation, ATE and RPE (mirror of
``compv_tpu/slam/evaluate.py``): RMSE of the translational error after a
Umeyama Sim(3) / SE(3) alignment of the estimated trajectory to the ground
truth (TUM benchmark definitions)."""
from __future__ import annotations

import torch

__all__ = ["umeyama_alignment", "ate_rmse", "rpe_rmse"]


def umeyama_alignment(est: torch.Tensor, gt: torch.Tensor,
                      with_scale: bool = True):
    """Least-squares similarity aligning est -> gt, (N, 3) each. Returns
    (scale, R (3, 3), t (3,))."""
    mu_e = est.mean(dim=0)
    mu_g = gt.mean(dim=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    u, d, vt = torch.linalg.svd(cov)
    s = torch.eye(3, dtype=est.dtype, device=est.device)
    s[2, 2] = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    r = u @ s @ vt
    var_e = (ec * ec).sum(dim=1).mean()
    if with_scale:
        scale = (d * torch.diagonal(s)).sum() / var_e.clamp_min(1e-12)
    else:
        scale = torch.ones((), dtype=est.dtype, device=est.device)
    t = mu_g - scale * (r @ mu_e)
    return scale, r, t


def ate_rmse(est: torch.Tensor, gt: torch.Tensor, with_scale: bool = True):
    """Absolute trajectory error RMSE after alignment, (N, 3) positions."""
    scale, r, t = umeyama_alignment(est, gt, with_scale)
    err = scale * (est @ r.T) + t - gt
    return (err * err).sum(dim=1).mean().sqrt()


def rpe_rmse(est: torch.Tensor, gt: torch.Tensor, delta: int = 1,
             align: bool = True, with_scale: bool = True):
    """Relative pose (translation) error RMSE over steps of ``delta``,
    after the Sim(3) alignment when ``align`` (a monocular estimate's scale
    is arbitrary)."""
    if align:
        scale, r, t = umeyama_alignment(est, gt, with_scale)
        est = scale * (est @ r.T) + t
    err = (est[delta:] - est[:-delta]) - (gt[delta:] - gt[:-delta])
    return (err * err).sum(dim=1).mean().sqrt()
