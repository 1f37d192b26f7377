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
  float in [1, 2) and subtracts 1;
* ``split(key)`` gives the keys threefry2x32(key, (0, i)), i = 0, 1 (the
  fold-like split);
* ``randint(key, shape, minval, maxval)`` splits the key, draws 32 bits
  from each half (hi, lo) and returns
  ``minval + ((hi % span) * m + lo % span) % span`` with ``span = maxval -
  minval`` (1 where ``maxval <= minval``) and ``m = (2**16 % span)**2 %
  span``, every product and the sum wrapping at 2**32
  (``jax._src.random._randint`` at 32 bits).

Unsigned 32-bit words are held in int64 tensors and masked after every
addition and shift, so the arithmetic is exact on every device.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["prng_key", "threefry2x32", "random_bits", "uniform", "split",
           "key_bits", "randint"]

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


def key_bits(key: tuple[int, int], shape: tuple[int, ...], device=None
             ) -> torch.Tensor:
    """32 random bits per element (int64 tensor of values < 2**32), equal to
    ``jax.random.bits(key, shape, uint32)`` for the key pair ``key``."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, i >> 32, i & _M32)
    return (b0 ^ b1).reshape(shape)


def random_bits(seed: int, shape: tuple[int, ...], device=None
                ) -> torch.Tensor:
    """``key_bits(prng_key(seed), shape)``: equal to
    ``jax.random.bits(PRNGKey(seed), shape, uint32)``."""
    return key_bits(prng_key(seed), shape, device)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as key pairs of Python ints."""
    i = torch.arange(num, dtype=torch.int64)
    b0, b1 = threefry2x32(key, torch.zeros_like(i), i)
    return list(zip(b0.tolist(), b1.tolist()))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2**32 for words a, b < 2**32 in int64, with no product
    above 2**48 (so nothing overflows int64)."""
    hi = ((a >> 16) * b) & 0xFFFF
    return ((hi << 16) + (a & 0xFFFF) * b) & _M32


def randint(key: tuple[int, int], shape: tuple[int, ...], minval,
            maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bit for
    bit. ``minval`` and ``maxval`` are ints or int tensors (a tensor on the
    card stays there: nothing waits on its value); ``device`` defaults to
    that of a tensor bound."""
    if device is None:
        device = next((v.device for v in (minval, maxval)
                       if isinstance(v, torch.Tensor)), None)
    k1, k2 = split(key)
    hi = key_bits(k1, shape, device)
    lo = key_bits(k2, shape, device)
    lo_v = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi_v = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    span = torch.where(hi_v <= lo_v, 1, (hi_v - lo_v) & _M32)
    m = 65536 % span
    mult = _mul32(m, m) % span
    off = (_mul32(hi % span, mult) + lo % span) & _M32
    return (lo_v + off % span).to(torch.int32)


@functools.lru_cache(maxsize=16)
def uniform(seed: int, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), shape)``: f32 in [0, 1).

    The table depends only on (seed, shape), so it is made once per device
    and cached; callers must not write into the returned tensor."""
    bits = random_bits(seed, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0
