"""KNN search: exact brute force and a random-projection ANN index (mirror
of ``compv_tpu/ml/knn.py``; reference CompVMachineLearningKNN, a wrapper of
annoy, base/include/compv/base/ml/compv_base_ml_knn.h:19-47).

Exact search is a distance matmul and a top-k; the ANN index hashes each
vector to the signs of its products with random hyperplanes and evaluates
exact distances on a shortlist of the nearest codes. Every top-k is the
port's stable ``top_k``: the lower index first among equal values,
as ``lax.top_k`` does. That matters most for the shortlist, a top-k over
small integer popcounts where ties are the rule.

The hyperplanes come from ``threefry.normal`` under the same key, within 4
ulp of ``jax.random.normal``; ``interop.model_from_numpy`` carries the
reference's own planes where a comparison must be exact.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.math.distance import squared_l2
from compv_tpu_torch.ops import threefry
from compv_tpu_torch.ops.topk import top_k

__all__ = ["KnnIndex", "knn_build", "knn_search", "knn_save_json",
           "knn_load_json", "AnnConfig", "AnnIndex", "ann_build",
           "ann_search"]


class KnnIndex(NamedTuple):
    vectors: torch.Tensor     # (N, D)
    norm: str                 # "l2" | "angular" (annoy's two metrics)


def _unit_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1,
                                                        keepdim=True), 1e-12)


def knn_build(vectors: torch.Tensor, norm: str = "l2") -> KnnIndex:
    v = vectors.to(torch.float32)
    if norm == "angular":
        v = _unit_rows(v)
    return KnnIndex(vectors=v, norm=norm)


def knn_search(index: KnnIndex, queries: torch.Tensor, k: int):
    """Exact top-k: (indices (M, k) int32, distances (M, k) float32)."""
    q = queries.to(torch.float32)
    if index.norm == "angular":
        vals, idx = top_k(_unit_rows(q) @ index.vectors.T, k)
        return idx.to(torch.int32), torch.sqrt(
            torch.clamp_min(2.0 - 2.0 * vals, 0.0))
    vals, idx = top_k(-squared_l2(q, index.vectors), k)
    return idx.to(torch.int32), torch.sqrt(torch.clamp_min(-vals, 0.0))


def knn_save_json(index: KnnIndex, path: str) -> None:
    with open(path, "w") as f:
        json.dump({"vectors": index.vectors.detach().cpu().tolist(),
                   "norm": index.norm}, f)


def knn_load_json(path: str, device=None) -> KnnIndex:
    """An index file of either package, on ``device`` (the card when none
    is given)."""
    with open(path) as f:
        obj = json.load(f)
    dev = device if device is not None else require_cuda()
    return KnnIndex(vectors=torch.tensor(obj["vectors"], dtype=torch.float32,
                                         device=dev), norm=obj["norm"])


# ------------------------------------------------------------- ANN variant

@dataclass(frozen=True)
class AnnConfig:
    n_projections: int = 16    # random hyperplanes (annoy's n_trees analogue)
    candidates: int = 256      # shortlist size per query
    seed: int = 0


class AnnIndex(NamedTuple):
    vectors: torch.Tensor      # (N, D)
    planes: torch.Tensor       # (P, D) random hyperplanes
    codes: torch.Tensor        # (N,) packed sign codes (int32, P <= 31)


def _codes(v: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    p = planes.shape[0]
    signs = (v @ planes.T) > 0                       # (N, P)
    weights = 2 ** torch.arange(p, dtype=torch.int32, device=v.device)
    return (signs.to(torch.int32) * weights).sum(dim=1, dtype=torch.int32)


def ann_build(vectors: torch.Tensor, config: AnnConfig = AnnConfig()
              ) -> AnnIndex:
    v = vectors.to(torch.float32)
    p = min(config.n_projections, 31)
    planes = threefry.normal(threefry.prng_key(config.seed), (p, v.shape[1]),
                             v.device)
    return AnnIndex(vectors=v, planes=planes, codes=_codes(v, planes))


# queries a chunk of the shortlist evaluation takes: the (chunk, c, D)
# gather stays near 2^26 floats
_CHUNK_FLOATS = 1 << 26


def ann_search(index: AnnIndex, queries: torch.Tensor, k: int,
               config: AnnConfig = AnnConfig()):
    """Shortlist of the ``config.candidates`` codes nearest in Hamming
    distance, then exact distances on it: (indices (M, k) int32, distances
    (M, k) float32)."""
    q = queries.to(torch.float32)
    p = index.planes.shape[0]
    xor = torch.bitwise_xor(_codes(q, index.planes)[:, None],
                            index.codes[None, :])
    pc = torch.zeros_like(xor)
    for b in range(p):
        pc += (xor >> b) & 1
    c = min(config.candidates, index.vectors.shape[0])
    cand = top_k(-pc, c)[1]                   # (M, c)
    d = index.vectors.shape[1]
    step = max(1, _CHUNK_FLOATS // (c * d))
    idx, dist = [], []
    for s in range(0, q.shape[0], step):
        cidx = cand[s:s + step]
        sub = index.vectors[cidx]                    # (m, c, D)
        diff = sub - q[s:s + step, None, :]
        vals, loc = top_k(-(diff * diff).sum(dim=2), k)
        idx.append(torch.gather(cidx, 1, loc))
        dist.append(torch.sqrt(torch.clamp_min(-vals, 0.0)))
    return torch.cat(idx).to(torch.int32), torch.cat(dist)
