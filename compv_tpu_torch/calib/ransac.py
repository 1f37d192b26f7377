"""Generic batched-hypothesis RANSAC (mirror of ``compv_tpu/calib/ransac.py``;
reference CompVMathStatsRansac::process,
base/math/compv_math_stats_ransac.cxx:36-110).

All hypotheses at once. The caller gives
  build_model(points_subset (k, d)) -> model (a tensor or a tuple / list /
                                       dict of tensors), vmapped over S
  residuals(model, points (n, d)) -> (n,) residuals, vmapped over S
and gets the model with the most inliers. Both run under
``torch.func.vmap``, so they must be written in batchable torch ops
without Python branches on values. The samples are the reference's: per
hypothesis, n uniforms of ``jax.random.uniform(PRNGKey(seed), (S, n))``
(the port's bit-exact ``ops/threefry``), the invalid points sunk to -1,
and the k largest by a stable sort (``lax.top_k``'s tie rule). The
homography's RANSAC draws its samples here too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from compv_tpu_torch.ops import threefry
from compv_tpu_torch.ops.topk import top_k

__all__ = ["RansacConfig", "RansacResult", "ransac"]


@dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 256
    min_model_points: int = 2
    threshold: float = 1.0
    seed: int = 0


class RansacResult(NamedTuple):
    model: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _take(tree, i):
    """Row ``i`` of every tensor of a model (tensor, tuple, list, dict or
    NamedTuple): the reference's tree_map(lambda m: m[best], models)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_take(v, i) for v in tree])
    return type(tree)(_take(v, i) for v in tree)


def _masked_sample_idx(seed: int, mask: torch.Tensor, s: int, k: int
                       ) -> torch.Tensor:
    """(s, k) random indices drawn without replacement from the valid
    positions of ``mask``: per hypothesis, N uniforms with invalid points
    sunk to -1, and the k largest (the reference's
    ``jax.random.uniform(PRNGKey(seed), (s, n))`` stream)."""
    u = threefry.uniform(seed, (s, mask.shape[0]), mask.device)
    u = torch.where(mask[None, :], u, -1.0)
    _, idx = top_k(u, k)
    return idx


def ransac(points: torch.Tensor, build_model: Callable, residuals: Callable,
           mask: torch.Tensor | None = None,
           config: RansacConfig = RansacConfig()) -> RansacResult:
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    idx = _masked_sample_idx(config.seed, mask, config.num_hypotheses,
                             config.min_model_points)         # (S, k)
    hyp_ok = mask[idx].all(dim=1)                            # enough valid

    models = torch.func.vmap(build_model)(points[idx])
    res = torch.func.vmap(residuals, in_dims=(0, None))(models, points)
    res = torch.where(torch.isfinite(res), res, torch.inf)   # (S, n)
    inl = (res < config.threshold) & mask[None, :] & hyp_ok[:, None]
    counts = inl.sum(dim=1)
    score = counts.to(torch.float32) - 1e-9 * torch.where(
        inl, res, 0.0).sum(dim=1)
    score = torch.where(hyp_ok, score, -torch.inf)
    best = torch.argmax(score)
    return RansacResult(model=_take(models, best), inliers=inl[best],
                        num_inliers=counts[best])
