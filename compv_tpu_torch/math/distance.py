"""Distance functions: Hamming, point-to-curve residuals, L2 (mirror of
``compv_tpu/math/distance.py``; reference CompVMathDistance,
base/math/compv_math_distance.cxx). The packed Hamming distance is a XOR
and a popcount of the port's ``ops/bitops``.
"""
from __future__ import annotations

import torch

from compv_tpu_torch.ops.bitops import popcount_bytes

__all__ = ["hamming", "hamming_packed", "dist_line", "dist_parabola",
           "squared_l2", "l2"]


def hamming_packed(data: torch.Tensor, patch: torch.Tensor) -> torch.Tensor:
    """Hamming distance of N packed descriptors to one patch:
    (N, B) u8 x (B,) u8 -> (N,) i32."""
    return popcount_bytes(torch.bitwise_xor(data, patch[None, :]))


def hamming(data_bits: torch.Tensor, patch_bits: torch.Tensor
            ) -> torch.Tensor:
    """Unpacked bits: (N, B) x (B,) {0,1} -> (N,) i32."""
    return (data_bits != patch_bits[None, :]).sum(dim=-1, dtype=torch.int32)


def dist_line(pts: torch.Tensor, a, b, c) -> torch.Tensor:
    """|ax + by + c| / sqrt(a^2 + b^2) for (N, 2) points (the robust line
    fit's residual). A degenerate model (a = b = 0, e.g. from a duplicate
    sample) gives +inf, so it never wins."""
    a, b, c = (v if isinstance(v, torch.Tensor) else pts.new_tensor(v)
               for v in (a, b, c))
    num = (a * pts[:, 0] + b * pts[:, 1] + c).abs()
    norm2 = a * a + b * b
    return torch.where(norm2 < 1e-20, torch.inf, num / (norm2 + 1e-30).sqrt())


def dist_parabola(pts: torch.Tensor, a, b, c, axis: str = "x"
                  ) -> torch.Tensor:
    """Vertical (axis "x") or horizontal (axis "y") distance to the
    parabola y = ax^2 + bx + c."""
    if axis == "x":
        return (pts[:, 1] - (a * pts[:, 0] ** 2 + b * pts[:, 0] + c)).abs()
    return (pts[:, 0] - (a * pts[:, 1] ** 2 + b * pts[:, 1] + c)).abs()


def squared_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2, (N, D) x (M, D) -> (N, M), by the matmul
    expansion."""
    aa = (a * a).sum(dim=1)
    bb = (b * b).sum(dim=1)
    return (aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)).clamp_min(0.0)


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return squared_l2(a, b).sqrt()
