"""jax.random's threefry2x32 stream in PyTorch, bit for bit.

The RANSAC sampler of ``calib/homography.py`` draws its hypotheses from
``jax.random.uniform(jax.random.PRNGKey(seed), (S, N))``; reproducing that
stream exactly is what lets the port meet the reference's homography
goldens and agree with it hypothesis by hypothesis. This follows the JAX
implementation with ``jax_threefry_partitionable=True`` (its default):

* ``PRNGKey(seed)`` is the key pair (seed >> 32, seed & 0xFFFFFFFF);
* the random bits of element i of a shape are ``x0 ^ x1`` of
  threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)), i the row-major flat index;
* an f32 uniform in [0, 1) puts the top 23 bits into the mantissa of a
  float in [1, 2) and subtracts 1.

Unsigned 32-bit words are held in int64 tensors and masked after every
addition and shift, so the arithmetic is exact on every device.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["prng_key", "threefry2x32", "random_bits", "uniform"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of Python ints."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (seed >> 32) & _M32, seed & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the count pair (x0, x1), each an int64
    tensor of 32-bit words; returns the two output words."""
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


def random_bits(seed: int, shape: tuple[int, ...], device=None
                ) -> torch.Tensor:
    """32 random bits per element (int64 tensor of values < 2**32), equal to
    ``jax.random.bits(PRNGKey(seed), shape, uint32)``."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(prng_key(seed), i >> 32, i & _M32)
    return (b0 ^ b1).reshape(shape)


@functools.lru_cache(maxsize=16)
def uniform(seed: int, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape)``: f32 in [0, 1).

    The table depends only on (seed, shape), so it is made once per device
    and cached; callers must not write into the returned tensor."""
    bits = random_bits(seed, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
