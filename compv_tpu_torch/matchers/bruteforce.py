"""Brute-force KNN Hamming matcher (mirror of
``compv_tpu/matchers/bruteforce.py``).

Descriptors are unpacked bit matrices Q (Nq, 256), T (Nt, 256) in {0,1}, so
hamming(q, t) = popcount(q) + popcount(t) - 2 <q, t> and the whole distance
matrix is one f32 matmul (exact: every partial sum is an integer <= 256).
KNN keeps ``lax.top_k``'s tie rule: among equal distances the lower train
index comes first.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from compv_tpu_torch.core.types import Matches
from compv_tpu_torch.ops.topk import select_top_k

__all__ = ["MatcherConfig", "hamming_distance_matrix", "knn_match",
           "match_bruteforce", "ratio_test"]


@dataclass(frozen=True)
class MatcherConfig:
    """Replaces COMPV_BRUTEFORCE_SET_INT_KNN / _BOOL_CROSS_CHECK
    (compv_matchers.h:27-42). Defaults: KNN=2, no cross-check."""
    knn: int = 2
    cross_check: bool = False
    norm: str = "hamming"


def hamming_distance_matrix(query_bits: torch.Tensor, train_bits: torch.Tensor
                            ) -> torch.Tensor:
    """(Nq, B) x (Nt, B) {0,1} bits -> (Nq, Nt) i32 Hamming distances."""
    dot = query_bits.to(torch.float32) @ train_bits.to(torch.float32).T
    pq = query_bits.to(torch.int32).sum(dim=1, dtype=torch.int32)
    pt = train_bits.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return pq[:, None] + pt[None, :] - 2 * dot.to(torch.int32)


def knn_match(query_bits: torch.Tensor, train_bits: torch.Tensor,
              query_valid: torch.Tensor | None = None,
              train_valid: torch.Tensor | None = None, k: int = 2) -> Matches:
    """K nearest train descriptors per query, in the (K, Nq) layout of the
    reference's Mat<CompVDMatch>(knn x Nq) (matcher_bruteforce.cxx:104)."""
    d = hamming_distance_matrix(query_bits, train_bits)
    big = 1 << 30
    if train_valid is not None:
        d = torch.where(train_valid[None, :], d, big)
    vals, idx = select_top_k(-d, k)          # (Nq, k)
    dist = (-vals).to(torch.float32)
    valid = vals > -big
    if query_valid is not None:
        valid = valid & query_valid[:, None]
    return Matches(train_idx=idx.T.to(torch.int32),
                   distance=torch.where(valid, dist, torch.inf).T,
                   valid=valid.T)


def match_bruteforce(query_bits: torch.Tensor, train_bits: torch.Tensor,
                     config: MatcherConfig = MatcherConfig(),
                     query_valid: torch.Tensor | None = None,
                     train_valid: torch.Tensor | None = None) -> Matches:
    """Facade matching CompVMatcherBruteForce::process; cross_check applies
    only for knn=1, as in the reference."""
    m = knn_match(query_bits, train_bits, query_valid, train_valid, config.knn)
    if config.cross_check and config.knn == 1:
        rev = knn_match(train_bits, query_bits, train_valid, query_valid, 1)
        nq = query_bits.shape[0]
        qidx = torch.arange(nq, dtype=torch.int32, device=query_bits.device)
        mutual = rev.train_idx[0][m.train_idx[0].to(torch.int64)] == qidx
        m = Matches(train_idx=m.train_idx,
                    distance=torch.where(mutual[None, :], m.distance,
                                         torch.inf),
                    valid=m.valid & mutual[None, :])
    return m


def ratio_test(matches: Matches, ratio: float = 0.67) -> torch.Tensor:
    """Lowe ratio test over queries: d1 < ratio * d2, with the ratio rounded
    to f32 as the reference multiplies it (object-recognition sample uses
    0.67). Requires knn >= 2. Returns (Nq,) bool."""
    d1 = matches.distance[0]
    d2 = matches.distance[1]
    return (matches.valid[0] & matches.valid[1]
            & (d1 < float(np.float32(ratio)) * d2))
