"""Batched weighted bincount (counterpart of ``compv_tpu/ops/bincount.py``).

The reference lowers the histogram to int8 one-hot matmuls for the TPU's
MXU. Here it is a plain scatter-add: integer adds are exact and give the
same sums in any order. The reference casts the weights to int8; this one
adds them as i32, which is the same for every weight its callers pass
(0 and 1).
"""
from __future__ import annotations

import torch

__all__ = ["batched_weighted_bincount"]


def batched_weighted_bincount(bins: torch.Tensor, weights: torch.Tensor,
                              n_bins: int, chunk_a: int = 4) -> torch.Tensor:
    """(A, E) integer bins in [0, n_bins), (A, E) integer weights ->
    (A, n_bins) i32 weighted counts. Rows are independent histograms.
    ``chunk_a`` (rows a step of the reference's matmul scan) is accepted
    and ignored: the scatter-add takes every row at once."""
    if bins.ndim != 2 or weights.shape != bins.shape:
        raise ValueError(f"bins and weights must be (A, E) of one shape, got "
                         f"{tuple(bins.shape)} and {tuple(weights.shape)}")
    a = bins.shape[0]
    acc = torch.zeros((a, n_bins), dtype=torch.int32, device=bins.device)
    return acc.scatter_add_(1, bins.to(torch.int64), weights.to(torch.int32))
