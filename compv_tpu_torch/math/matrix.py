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

Integer matrices give the reference's dtypes: ``trace`` sums as
``jnp.trace`` does (int32 for a signed input, uint32 for an unsigned one),
``determinant`` and ``inverse_diagonal`` are float32, and the predicates
subtract with the input dtype's wrap-around, in int64 (PyTorch has no
CPU ``-`` or ``abs`` for uint16 and uint32). Every entry takes float64 as
float32 and int64 as int32 (``core.types.at_x64_off``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from compv_tpu_torch.core.types import at_x64_off, is_integer_dtype
from compv_tpu_torch.math.ops import _wrap, _wrap_mul

class SVDResult(NamedTuple):
    """``svd``'s result: its fields are ``jnp.linalg.svd``'s."""
    U: torch.Tensor
    S: torch.Tensor
    Vh: torch.Tensor


__all__ = ["mul_ab", "mul_abt", "mul_ata", "mul_ag", "mul_ga", "transpose",
           "rank", "is_symmetric", "is_colinear_2d", "eigen_symm", "svd",
           "pseudo_inverse", "inverse_3x3", "inverse_diagonal", "trace",
           "determinant"]


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a if a.dtype == torch.float32 else a.to(torch.float32)


@at_x64_off
def mul_ab(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B in float32."""
    return torch.matmul(_f32(a), _f32(b))


@at_x64_off
def mul_abt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B^T, contracting the last axis of each (reference mulABt)."""
    return torch.tensordot(_f32(a), _f32(b), dims=([a.ndim - 1],
                                                   [b.ndim - 1]))


@at_x64_off
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


@at_x64_off
def mul_ag(a: torch.Tensor, i: int, j: int, c, s) -> torch.Tensor:
    """Right-multiply by a Givens rotation (reference mulAG)."""
    return a @ _givens(a.shape[1], i, j, c, s, a)


@at_x64_off
def mul_ga(a: torch.Tensor, i: int, j: int, c, s) -> torch.Tensor:
    """Left-multiply by a Givens rotation (reference mulGA)."""
    return _givens(a.shape[0], i, j, c, s, a) @ a


@at_x64_off
def transpose(a: torch.Tensor) -> torch.Tensor:
    return a.T


@at_x64_off
def rank(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Singular values above ``tol`` times the largest; () int32."""
    s = torch.linalg.svdvals(a)
    return (s > tol * s.max()).sum(dtype=torch.int32)


@at_x64_off
def is_symmetric(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """|A - A^T| <= tol everywhere, the difference and its magnitude taken
    in A's dtype (an unsigned one wraps)."""
    if is_integer_dtype(a.dtype):
        v = a.to(torch.int64)
        d = _wrap(_wrap(v - v.T, a.dtype).abs(), a.dtype)
        return torch.all(d <= tol)
    return torch.all((a - a.T).abs() <= tol)




@at_x64_off
def is_colinear_2d(pts: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """True if (N, 2) points are colinear (the homography's 4-point sample
    rejection)."""
    if is_integer_dtype(pts.dtype):
        dt = pts.dtype              # the reference's wrap-around in dt
        p = pts.to(torch.int64)
        d = _wrap(p[1:] - p[0], dt)
        cross = _wrap(_wrap_mul(d[:, 0][None, :], d[:, 1][:, None], dt)
                      - _wrap_mul(d[:, 1][None, :], d[:, 0][:, None], dt),
                      dt)
        scale = _wrap(d.abs(), pts.dtype).max().to(torch.float32) + 1e-12
        cross = _wrap(cross.abs(), pts.dtype).to(torch.float32)
        return torch.all(cross <= tol * scale * scale)
    d = pts[1:] - pts[0]
    cross = (d[:, 0][None, :] * d[:, 1][:, None]
             - d[:, 1][None, :] * d[:, 0][:, None])
    scale = d.abs().max() + 1e-12
    return torch.all(cross.abs() <= tol * scale * scale)


@at_x64_off
def eigen_symm(s: torch.Tensor, sort: bool = True):
    """Eigen decomposition of a symmetric matrix (or a batch): (values,
    vectors as columns), values descending when ``sort``."""
    vals, vecs = torch.linalg.eigh(s)
    if sort:            # eigh returns ascending; the reference descending
        vals = vals.flip(-1)
        vecs = vecs.flip(-1)
    return vals, vecs


@at_x64_off
def svd(a: torch.Tensor) -> "SVDResult":
    """Thin SVD: ``SVDResult(U, S, Vh)``, the named tuple that
    ``jnp.linalg.svd`` returns."""
    return SVDResult(*torch.linalg.svd(a, full_matrices=False))


@at_x64_off
def pseudo_inverse(a: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse, singular values at or below ``tol``
    times the largest dropped (reference pseudoinv)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    cutoff = tol * s.amax(-1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
    return (vt.mT * s_inv[..., None, :]) @ u.mT


@at_x64_off
def inverse_3x3(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a 3 x 3 matrix (or a batch), the pseudo-inverse where
    |det| <= 1e-12 (reference invA3x3)."""
    det = determinant(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    inv = torch.linalg.inv_ex(a + 1e-30 * eye)[0]
    return torch.where((det.abs() > 1e-12)[..., None, None], inv,
                       pseudo_inverse(a))


@at_x64_off
def inverse_diagonal(d: torch.Tensor) -> torch.Tensor:
    """Inverse of the diagonal of a matrix (or a batch), 0 where a diagonal
    entry's magnitude is at or below 1e-12 (reference invD)."""
    diag = torch.diagonal(d, dim1=-2, dim2=-1)
    if not diag.dtype.is_floating_point:
        diag = diag.to(torch.float32)
    inv = torch.where(diag.abs() > 1e-12, 1.0 / diag, torch.zeros_like(diag))
    return torch.diag_embed(inv)


@at_x64_off
def trace(a: torch.Tensor) -> torch.Tensor:
    """Sum of the diagonal in ``jnp.trace``'s dtype: an integer matrix sums
    (wrapping) into int32 when signed, uint32 when unsigned."""
    if is_integer_dtype(a.dtype):
        acc = torch.int32 if a.dtype.is_signed else torch.uint32
        s = torch.diagonal(a).to(torch.int64).sum()
        return _wrap(s, acc).to(acc)
    return torch.trace(a)


@at_x64_off
def determinant(a: torch.Tensor) -> torch.Tensor:
    """det of a square matrix (or a batch): the cofactor expansion for
    2 x 2 and 3 x 3, as ``jnp.linalg.det`` computes them (a numerically
    singular 3 x 3 matrix of small integers gets det 0 exactly, where an LU
    would round to a tiny nonzero), an LU past that. An integer matrix is
    float32 first, as ``jnp.linalg.det`` promotes it."""
    if not a.dtype.is_floating_point:
        a = a.to(torch.float32)
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
