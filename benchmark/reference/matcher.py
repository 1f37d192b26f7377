"""Plain brute-force KNN-2 Hamming matching with Lowe's ratio test.

The distance is a count of unequal bits (not the port's matmul form);
among equal distances the lower train index comes first; a query matches
when both neighbours exist and d1 < f32(ratio) * d2.
"""
from __future__ import annotations

import numpy as np
import torch


def knn2_ratio(q_bits, q_valid, t_bits, t_valid, ratio: float,
               block: int = 256):
    """(Nq, B), (Nt, B) {0,1} u8 bits -> (first train index (Nq,) int64,
    its distance (Nq,) f32, ratio-test pass (Nq,) bool)."""
    big = 1 << 30
    idx_out, d_out, ok_out = [], [], []
    for s in range(0, q_bits.shape[0], block):
        q = q_bits[s:s + block]
        d = (q[:, None, :] != t_bits[None, :, :]).sum(-1, dtype=torch.int64)
        d = torch.where(t_valid[None, :], d, big)
        vals, idx = torch.sort(d, dim=1, stable=True)
        d1, d2 = vals[:, 0], vals[:, 1]
        both = (d1 < big) & (d2 < big) & q_valid[s:s + block]
        ok = both & (d1.to(torch.float32)
                     < float(np.float32(ratio)) * d2.to(torch.float32))
        idx_out.append(idx[:, 0])
        d_out.append(d1.to(torch.float32))
        ok_out.append(ok)
    return torch.cat(idx_out), torch.cat(d_out), torch.cat(ok_out)
