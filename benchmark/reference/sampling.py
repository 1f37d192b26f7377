"""The RANSAC hypothesis stream the configurations state: ``seed``'s
threefry2x32 uniforms (``jax.random.uniform(PRNGKey(seed), (S, N))``,
partitionable layout) with the invalid rows sunk to -1, and the k largest
of each row, the lower index first among ties.

A frozen copy of the port's ``ops/threefry.py`` (``prng_key``,
``threefry2x32``, ``uniform``) and ``calib/ransac.py``'s
``_masked_sample_idx``: 32-bit words in int64, masked after every
addition and shift, so the stream is exact on every device.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key, x0, x1):
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniform(seed: int, shape, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) of the key (seed >> 32, seed & 0xFFFFFFFF)."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(((seed >> 32) & _M32, seed & _M32), i >> 32,
                          i & _M32)
    mant = ((((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)).reshape(shape)
    return mant.view(torch.float32) - 1.0


def masked_sample_idx(seed: int, mask: torch.Tensor, s: int, k: int):
    """(s, k) int64 indices of valid rows, without replacement a row."""
    u = uniform(seed, (s, mask.shape[0]), mask.device)
    u = torch.where(mask[None, :], u, -1.0)
    _, idx = torch.sort(u, dim=-1, descending=True, stable=True)
    return idx[:, :k]
