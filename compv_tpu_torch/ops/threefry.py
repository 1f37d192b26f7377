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
* ``normal(key, shape)`` draws a uniform in (-1, 1) the same way
  (``u * 2 + nextafter(-1, 0)``, floored there) and returns
  ``sqrt(2) * erf_inv(u)`` by the polynomial that XLA expands ``erf_inv``
  into (Giles' single-precision form, two sets of nine coefficients split
  at ``w = -log1p(-u^2) = 5``). The uniforms are bit-exact; XLA:CPU's
  ``log1p`` and ``sqrt`` are its own approximations, so the normals agree
  with ``jax.random.normal`` within a few ulp, not bit for bit;
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
           "key_bits", "randint", "normal"]

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


# XLA's erf_inv expansion for f32 (Giles 2010), highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_ABOVE_MINUS_ONE = -0.99999994039535522   # nextafter(-1, 0) in f32
_SQRT2_F32 = 1.41421353816986084          # f32(sqrt(2))


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-u * u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, w.sqrt() - 3.0)

    def coef(i):
        return torch.where(lt, u.new_tensor(_ERFINV_LT5[i]),
                           u.new_tensor(_ERFINV_GE5[i]))

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    return torch.where(u.abs() == 1.0, u * torch.inf, p * u)


def normal(key: tuple[int, int], shape: tuple[int, ...], device=None
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32) for the key pair ``key``:
    the same uniforms bit for bit, the same erf_inv polynomial (within a
    few ulp of the reference, see the module docstring)."""
    bits = key_bits(key, shape, device)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = mant.view(torch.float32) - 1.0
    u = (f * 2.0 + _ABOVE_MINUS_ONE).clamp_min(_ABOVE_MINUS_ONE)
    return _erf_inv(u) * _SQRT2_F32
