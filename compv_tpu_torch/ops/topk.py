"""Exact top-k with ``lax.top_k``'s tie rule.

``lax.top_k`` (and ``approx_max_k``, which is exact on the CPU backend the
reference's goldens come from) puts the lower index first among equal
values. FAST strengths are small integers, so ties are common and decide
which keypoints survive a level's budget. ``torch.topk`` promises no tie
order, so the port takes the first k of a stable descending sort: equal
values keep their index order.
"""
from __future__ import annotations

import torch

__all__ = ["select_top_k", "select_top_k_2d"]


def select_top_k(x: torch.Tensor, k: int):
    """(..., N) values -> (values (..., k), int64 indices (..., k)),
    descending along the last axis; always exact (the reference's
    ``exact=False`` is exact on its CPU backend too)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_top_k_2d(img_vals: torch.Tensor, k: int):
    """Top-k over a dense 2-D map -> (values (k,), flat indices (k,))."""
    return select_top_k(img_vals.to(torch.float32).reshape(-1), k)
