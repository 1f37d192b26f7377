"""Dense matrix operations (mirror of ``compv_tpu/math/matrix.py``;
reference CompVMatrix, base/math/compv_math_matrix.cxx): products, Givens
rotations, rank, symmetry and colinearity tests, eigen / SVD /
pseudo-inverse, inverses, trace and determinant.

The decompositions go to ``torch.linalg`` (LAPACK on the CPU, cuSOLVER on
the card): eigen- and singular-vectors agree with the reference's up to
sign. ``determinant`` of a 2 x 2 or 3 x 3 matrix is the cofactor
expansion that ``jnp.linalg.det`` uses for them. ``pseudo_inverse``,
``inverse_3x3`` and ``inverse_diagonal`` also take a batch of matrices
(..., m, n); for one matrix they are the reference's formulas.
``inverse_3x3`` inverts through ``inv_ex``, which neither raises on a
singular matrix nor waits for the card, and keeps the reference's select
between the inverse and the pseudo-inverse.
"""
from __future__ import annotations

import torch

__all__ = ["mul_ab", "mul_abt", "mul_ata", "mul_ag", "mul_ga", "transpose",
           "rank", "is_symmetric", "is_colinear_2d", "eigen_symm", "svd",
           "pseudo_inverse", "inverse_3x3", "inverse_diagonal", "trace",
           "determinant"]


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a if a.dtype == torch.float32 else a.to(torch.float32)


def mul_ab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B in float32."""
    return torch.matmul(_f32(a), _f32(b))


def mul_abt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B^T, contracting the last axis of each (reference mulABt)."""
    return torch.tensordot(_f32(a), _f32(b), dims=([a.ndim - 1],
                                                   [b.ndim - 1]))


def mul_ata(a: torch.Tensor) -> torch.Tensor:
    """A^T @ A, contracting the first axis (reference mulAtA, which forms
    the DLT's normal equations)."""
    a = _f32(a)
    return torch.tensordot(a, a, dims=([0], [0]))


def _givens(n: int, i: int, j: int, c, s, like: torch.Tensor
            ) -> torch.Tensor:
    g = torch.eye(n, dtype=like.dtype, device=like.device)
    g[i, i] = c
    g[j, j] = c
    g[i, j] = s
    g[j, i] = -s
    return g


def mul_ag(a: torch.Tensor, i: int, j: int, c, s) -> torch.Tensor:
    """Right-multiply by a Givens rotation (reference mulAG)."""
    return a @ _givens(a.shape[1], i, j, c, s, a)


def mul_ga(a: torch.Tensor, i: int, j: int, c, s) -> torch.Tensor:
    """Left-multiply by a Givens rotation (reference mulGA)."""
    return _givens(a.shape[0], i, j, c, s, a) @ a


def transpose(a: torch.Tensor) -> torch.Tensor:
    return a.T


def rank(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Singular values above ``tol`` times the largest; () int32."""
    s = torch.linalg.svdvals(a)
    return (s > tol * s.max()).sum(dtype=torch.int32)


def is_symmetric(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    return torch.all((a - a.T).abs() <= tol)


def is_colinear_2d(pts: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """True if (N, 2) points are colinear (the homography's 4-point sample
    rejection)."""
    d = pts[1:] - pts[0]
    cross = (d[:, 0][None, :] * d[:, 1][:, None]
             - d[:, 1][None, :] * d[:, 0][:, None])
    scale = d.abs().max() + 1e-12
    return torch.all(cross.abs() <= tol * scale * scale)


def eigen_symm(s: torch.Tensor, sort: bool = True):
    """Eigen decomposition of a symmetric matrix (or a batch): (values,
    vectors as columns), values descending when ``sort``."""
    vals, vecs = torch.linalg.eigh(s)
    if sort:            # eigh returns ascending; the reference descending
        vals = vals.flip(-1)
        vecs = vecs.flip(-1)
    return vals, vecs


def svd(a: torch.Tensor):
    """Thin SVD: (U, S, Vh)."""
    return tuple(torch.linalg.svd(a, full_matrices=False))


def pseudo_inverse(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse, singular values at or below ``tol``
    times the largest dropped (reference pseudoinv)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    cutoff = tol * s.amax(-1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return (vt.mT * s_inv[..., None, :]) @ u.mT


def inverse_3x3(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3 x 3 matrix (or a batch), the pseudo-inverse where
    |det| <= 1e-12 (reference invA3x3)."""
    det = determinant(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    inv = torch.linalg.inv_ex(a + 1e-30 * eye)[0]
    return torch.where((det.abs() > 1e-12)[..., None, None], inv,
                       pseudo_inverse(a))


def inverse_diagonal(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the diagonal of a matrix (or a batch), 0 where a diagonal
    entry's magnitude is at or below 1e-12 (reference invD)."""
    diag = torch.diagonal(d, dim1=-2, dim2=-1)
    inv = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    return torch.diag_embed(inv)


def trace(a: torch.Tensor) -> torch.Tensor:
    return torch.trace(a)


def determinant(a: torch.Tensor) -> torch.Tensor:
    """det of a square matrix (or a batch): the cofactor expansion for
    2 x 2 and 3 x 3, as ``jnp.linalg.det`` computes them (a numerically
    singular 3 x 3 matrix of small integers gets det 0 exactly, where an LU
    would round to a tiny nonzero), an LU past that."""
    n = a.shape[-1]
    if n == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    if n == 3:
        return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
                + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
                + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
                - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
                - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
                - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])
    return torch.linalg.det(a)
