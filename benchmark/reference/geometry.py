"""Plain geometry for the benchmark's checks: the RANSAC homography.

It computes what the configuration states, in float64: it draws the
stated hypothesis stream (``sampling.py``), solves each minimal sample,
scores, refines and keeps by the stated rules. None of it is the
program's code, and it takes nothing the program computed.
``quant`` is the arithmetic's rounding: none for the reference, a round
trip through bfloat16 for the control (torch's solvers take no bfloat16,
so the control stores every value it computes in bfloat16 and solves in
float64 on those values).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import sampling

F64 = torch.float64


def no_quant(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16_quant(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# ------------------------------------------------------------- homography

def _hartley(p: torch.Tensor, w: torch.Tensor):
    n = w.sum(-1).clamp_min(1.0)
    c = (p * w[..., None]).sum(-2) / n[..., None]
    d = (((p - c[..., None, :]) ** 2).sum(-1).sqrt() * w).sum(-1) / n
    s = np.sqrt(2.0) / d.clamp_min(1e-12)
    t = torch.zeros(p.shape[:-2] + (3, 3), dtype=p.dtype, device=p.device)
    t[..., 0, 0] = s
    t[..., 1, 1] = s
    t[..., 0, 2] = -s * c[..., 0]
    t[..., 1, 2] = -s * c[..., 1]
    t[..., 2, 2] = 1.0
    return (p - c[..., None, :]) * s[..., None, None], t


def homography_dlt(src, dst, w, quant=no_quant):
    """Weighted normalized DLT over (..., N, 2) point sets -> (..., 3, 3)
    with H[2, 2] = 1."""
    sn, ts = _hartley(src, w)
    dn, td = _hartley(dst, w)
    x, y, u, v = sn[..., 0], sn[..., 1], dn[..., 0], dn[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    a = quant(torch.cat([r1, r2], -2) * torch.cat([w, w], -1)[..., None])
    _, vecs = torch.linalg.eigh(quant(a.mT @ a))
    hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    h = torch.linalg.inv_ex(td).inverse @ hn @ ts
    return quant(h / h[..., 2:3, 2:3])


def transfer_error(h, src, dst):
    """Symmetric transfer error d(H s, d)^2 + d(H^-1 d, s)^2, (..., N)."""
    def apply(m, p):
        ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
        q = ph @ m.mT
        return q[..., :2] / q[..., 2:3]

    hinv = torch.linalg.inv_ex(h).inverse
    return (((apply(h, src) - dst) ** 2).sum(-1)
            + ((apply(hinv, dst) - src) ** 2).sum(-1))


def _nondegenerate(p4):
    """(..., 4, 2) -> no 3 of the 4 points (nearly) colinear."""
    triples = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
    a = torch.stack([p4[..., j, :] - p4[..., i, :] for i, j, _ in triples], -2)
    b = torch.stack([p4[..., l, :] - p4[..., i, :] for i, _, l in triples], -2)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    scale = ((a * a).sum(-1) + (b * b).sum(-1)).clamp_min(1e-12)
    return (cross.abs() > 1e-5 * scale).all(-1)


def find_homography(src, dst, mask, hypotheses: int, threshold: float,
                    seed: int = 0, quant=no_quant):
    """RANSAC over the stated stream of 4-point samples: the exact
    homography through each, non-degenerate samples only, the most inliers
    winning (less summed inlier error breaking ties), then a DLT on the
    winner's inliers kept where it has as many. Returns (H (3, 3) float64,
    inliers (N,) bool)."""
    src = quant(src.to(F64))
    dst = quant(dst.to(F64))
    idx = sampling.masked_sample_idx(seed, mask, hypotheses, 4)
    s4, d4 = src[idx], dst[idx]
    hs = homography_dlt(s4, d4, torch.ones(idx.shape, dtype=F64,
                                           device=src.device), quant)
    ok = (_nondegenerate(s4) & _nondegenerate(d4) & mask[idx].all(1)
          & torch.isfinite(hs).all(2).all(1))
    err = transfer_error(hs, src, dst)
    err = torch.where(torch.isfinite(err), err, torch.inf)
    inl = (err < threshold) & mask[None, :] & ok[:, None]
    score = inl.sum(1).to(F64) - 1e-9 * torch.where(inl, err, 0.0).sum(1)
    best = torch.argmax(torch.where(ok, score, -torch.inf))
    h, inl_b = hs[best], inl[best]
    h2 = homography_dlt(src, dst, inl_b.to(F64), quant)
    inl2 = (transfer_error(h2, src, dst) < threshold) & mask
    if int(inl2.sum()) >= int(inl_b.sum()):
        h, inl_b = h2, inl2
    return h, inl_b


def apply_h(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    q = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ np.asarray(h).T
    return q[:, :2] / q[:, 2:3]

