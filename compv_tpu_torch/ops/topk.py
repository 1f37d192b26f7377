"""Exact top-k with ``lax.top_k``'s tie rule.

``lax.top_k`` (and ``approx_max_k``, which is exact on the CPU backend the
reference's goldens come from) puts the lower index first among equal
values. FAST strengths are small integers, so ties are common and decide
which keypoints survive a level's budget. ``torch.topk`` promises no tie
order, so the port takes the first k of a stable descending sort: equal
values keep their index order.

Both of the reference's selections raise ``ValueError`` when k exceeds the
values along the axis; so do these. The public entries return the
reference's dtypes (int32 indices, float32 for float64 values); the
package's own callers take ``top_k`` / ``top_k_2d``, whose int64 indices
feed ``gather`` and ``index_select`` directly.
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import x64_off

__all__ = ["select_top_k", "select_top_k_2d"]


def top_k(x: torch.Tensor, k: int):
    """(..., N) values -> (values (..., k), int64 indices (..., k)),
    descending along the last axis, the lower index first among ties."""
    n = x.shape[-1] if x.ndim else 1
    if k > n:
        raise ValueError(f"top-k: k={k} exceeds the {n} values along the "
                         f"last axis of a {tuple(x.shape)} tensor")
    if x.dtype in (torch.uint16, torch.uint32):   # no sort of them on the
        vals, idx = torch.sort(x.to(torch.int64), dim=-1,   # card: in int64
                               descending=True, stable=True)
        return vals[..., :k].to(x.dtype), idx[..., :k]
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_2d(img_vals: torch.Tensor, k: int):
    """Top-k over a dense 2-D map -> (float32 values (k,), int64 flat
    indices (k,))."""
    return top_k(img_vals.to(torch.float32).reshape(-1), k)


def select_top_k(x: torch.Tensor, k: int, exact: bool = False):
    """(..., N) values -> (values (..., k), int32 indices (..., k)),
    descending along the last axis. Always exact: ``exact`` chooses
    between ``lax.top_k`` and the TPU's ``approx_max_k`` in the reference
    and is accepted and ignored here (``approx_max_k`` is exact on the
    reference's CPU backend too)."""
    vals, idx = top_k(x64_off(x), k)
    return vals, idx.to(torch.int32)


def select_top_k_2d(img_vals: torch.Tensor, k: int, exact: bool = False):
    """Top-k over a dense 2-D map -> (float32 values (k,), int32 flat
    indices (k,)); ``exact`` as in ``select_top_k``."""
    vals, idx = top_k_2d(img_vals, k)
    return vals, idx.to(torch.int32)
