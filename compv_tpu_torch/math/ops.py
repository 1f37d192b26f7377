"""Element-wise math: saturating integer arithmetic, casts, activations,
trig, image moments (mirror of ``compv_tpu/math/ops.py``; reference
base/math/compv_math_op_*.cxx, compv_math_cast.cxx, compv_math_trig.h).

Integer arithmetic saturates for dtypes of 16 bits or less and wraps for
32-bit ones, as in the reference. PyTorch implements neither ``+``, ``>>``,
``abs``, ``min`` nor ``clamp`` for ``uint16`` on the CPU and little for
``uint32`` on the CPU or the card, so every integer operation runs in
int64, where each of them is exact (products of two 32-bit words are split
in 16-bit halves), and the result is clipped or wrapped and cast back.
Where ``jnp`` promotes an integer input to float32 (``hypot_``,
``tanh_activation``, ``fast_exp``, the atan2s, a float scale), the port
casts it first; ``logistic_activation`` raises ``TypeError`` on one, as
``jax.nn.sigmoid`` does. Every entry takes float64 as float32 and int64 as
int32 (``core.types.at_x64_off``).

``image_moments`` forms x^p by repeated multiplication, x * (x * x) for the
cube, as JAX's ``integer_pow`` does: at x up to 1281 a cube passes 2^24, and
``torch.pow`` would round it otherwise. The sums are float32 in PyTorch's
order, so the moments agree with the reference within a relative
tolerance, not bit for bit.
"""
from __future__ import annotations

import torch

from compv_tpu_torch.core.types import (at_x64_off, is_integer_dtype,
                                       x64_off_dtype)

__all__ = ["add", "sub", "mul_elementwise", "abs_", "minmax", "clip",
           "scale_values", "cast", "tanh_activation", "logistic_activation",
           "relu", "fast_exp", "fast_atan2_deg", "atan2_deg_exact",
           "hypot_", "image_moments", "hu_moments"]


def _range(dtype: torch.dtype) -> tuple[int, int]:
    info = torch.iinfo(dtype)
    return info.min, info.max


def _as_int64(b, dtype: torch.dtype, device) -> torch.Tensor:
    """``b`` (tensor or Python number) as ``dtype`` would hold it, in
    int64."""
    if isinstance(b, torch.Tensor):
        return _wrap(b.to(device).to(torch.int64), dtype)
    return _wrap(torch.tensor(int(b), dtype=torch.int64, device=device),
                 dtype)


def _wrap(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values reduced modulo 2^bits into ``dtype``'s range."""
    lo, hi = _range(dtype)
    span = hi - lo + 1
    return torch.remainder(v - lo, span) + lo


def _wrap_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values wrapped into ``dtype`` and cast to it."""
    return _wrap(v, dtype).to(dtype)


def _float(a: torch.Tensor) -> torch.Tensor:
    """``jnp``'s promotion of an integer (or bool) input of a float
    function: float32."""
    return a if a.dtype.is_floating_point else a.to(torch.float32)


def _mul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b modulo 2^32 of int64 tensors holding 32-bit words, without an
    int64 overflow: a = ah 2^16 + al, a b = al b + ((ah b) mod 2^16) 2^16
    (mod 2^32), each product below 2^48."""
    a = a & 0xFFFFFFFF
    b = b & 0xFFFFFFFF
    al, ah = a & 0xFFFF, a >> 16
    return (al * b + (((ah * b) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _wrap_mul(x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """x * y of int64 tensors holding ``dtype`` values, wrapped into
    ``dtype``'s range (still int64)."""
    if torch.iinfo(dtype).bits > 16:
        return _wrap(_mul_mod32(x, y), dtype)
    return _wrap(x * y, dtype)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b. Two integer tensors of one dtype multiply in that dtype,
    wrapping, as ``jnp.matmul`` does: in int64, by broadcast products
    summed over slices of the contraction axis of at most 2^24 products
    each (PyTorch's CUDA matmul takes no integers; an int64 sum that wraps
    keeps every result mod 2^32)."""
    if not (is_integer_dtype(a.dtype) and a.dtype == b.dtype):
        return a @ b
    x, y = a.to(torch.int64), b.to(torch.int64)
    k = x.shape[-1]
    step = max(1, (1 << 24) // max(1, x.numel() // max(k, 1)
                                    * y.shape[-1]))
    acc = None
    for j in range(0, k, step):
        p = (x[..., :, j:j + step, None] * y[..., None, j:j + step, :]
             ).sum(dim=-2)
        acc = p if acc is None else acc + p
    if acc is None:                 # an empty contraction
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=torch.int64,
                          device=x.device)
    return _wrap_to(acc, a.dtype)


def _int_op(a: torch.Tensor, b, op: str) -> torch.Tensor:
    dt = a.dtype
    if dt == torch.int64:           # no reference counterpart: plain
        y = torch.as_tensor(b, dtype=dt, device=a.device)
        return {"add": a + y, "sub": a - y, "mul": a * y}[op]
    x = a.to(torch.int64)
    y = _as_int64(b, dt, a.device)
    bits = torch.iinfo(dt).bits
    if op == "add":
        v = x + y
    elif op == "sub":
        v = x - y
    elif bits > 16:
        v = _mul_mod32(x, y)
    else:
        v = x * y
    if bits > 16:                   # 32-bit: wraps, as C arithmetic does
        return _wrap(v, dt).to(dt)
    lo, hi = _range(dt)
    return v.clamp(lo, hi).to(dt)


@at_x64_off
def add(a: torch.Tensor, b) -> torch.Tensor:
    """Saturating add for integer dtypes of 16 bits or less, wrapping for
    32-bit ones, plain add for floats."""
    if is_integer_dtype(a.dtype):
        return _int_op(a, b, "add")
    return a + b


@at_x64_off
def sub(a: torch.Tensor, b) -> torch.Tensor:
    """Saturating subtract for integer dtypes of 16 bits or less; see
    add()."""
    if is_integer_dtype(a.dtype):
        return _int_op(a, b, "sub")
    return a - b


@at_x64_off
def mul_elementwise(a: torch.Tensor, b) -> torch.Tensor:
    """Saturating element-wise multiply for integer dtypes of 16 bits or
    less, wrapping for 32-bit ones; see add()."""
    if is_integer_dtype(a.dtype):
        return _int_op(a, b, "mul")
    return a * b


@at_x64_off
def abs_(a: torch.Tensor) -> torch.Tensor:
    """|a|; an integer dtype's minimum wraps to itself, as in C."""
    if is_integer_dtype(a.dtype):
        return _wrap_to(a.to(torch.int64).abs(), a.dtype)
    return a.abs()


@at_x64_off
def minmax(a: torch.Tensor):
    """(min, max) of a tensor (reference CompVMathOpMinMax)."""
    if is_integer_dtype(a.dtype):
        v = a.to(torch.int64)
        return v.min().to(a.dtype), v.max().to(a.dtype)
    return a.min(), a.max()


@at_x64_off
def clip(a: torch.Tensor, lo, hi) -> torch.Tensor:
    if is_integer_dtype(a.dtype) and a.dtype != torch.int64:
        return a.to(torch.int64).clamp(lo, hi).to(a.dtype)
    return a.clamp(lo, hi)


@at_x64_off
def scale_values(a: torch.Tensor, s) -> torch.Tensor:
    """a * s: an integer tensor times a Python int wraps in its dtype, times
    a float it is float32 (``jnp``'s weak-type promotion)."""
    if is_integer_dtype(a.dtype) and not isinstance(s, torch.Tensor):
        if isinstance(s, int):
            return _wrap_to(a.to(torch.int64) * s, a.dtype)
        return a.to(torch.float32) * s
    return a * s


@at_x64_off
def cast(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Saturating cast for integer targets: round half to even in float32,
    clip to the target's range (reference compv_math_cast). A 64-bit
    target is its 32-bit dtype, as with JAX's x64 off."""
    dtype = x64_off_dtype(dtype)
    if is_integer_dtype(dtype):
        lo, hi = _range(dtype)
        r = torch.round(a.to(torch.float32)).to(torch.float64)
        # the clip in float64 reaches the range's ends exactly; a NaN
        # becomes 0, as XLA's saturating conversion makes it
        r = torch.nan_to_num(r, nan=0.0).clamp(lo, hi)
        return r.to(torch.int64).to(dtype)
    return a.to(dtype)


@at_x64_off
def tanh_activation(a: torch.Tensor) -> torch.Tensor:
    return torch.tanh(_float(a))


@at_x64_off
def logistic_activation(a: torch.Tensor) -> torch.Tensor:
    """The logistic sigmoid of a float tensor; an integer or bool one
    raises ``TypeError``, as ``jax.nn.sigmoid`` does."""
    if not a.dtype.is_floating_point:
        raise TypeError(f"logistic_activation takes a float tensor, got "
                        f"{a.dtype}")
    return torch.sigmoid(a)


@at_x64_off
def relu(a: torch.Tensor) -> torch.Tensor:
    if is_integer_dtype(a.dtype):
        return a.to(torch.int64).clamp_min(0).to(a.dtype)
    return torch.clamp_min(a, 0)


@at_x64_off
def fast_exp(a: torch.Tensor) -> torch.Tensor:
    return torch.exp(_float(a))


# degree-7 odd minimax polynomial for atan on [0, 1], in degrees (the
# reference's fastAtan2, base/math/compv_math.cxx:39-43)
_ATAN2_EPS = 2.2204460492503131e-16
_ATAN2_P = (57.2836266, -18.6674461, 8.91400051, -2.53972459)


@at_x64_off
def fast_atan2_deg(y, x) -> torch.Tensor:
    """Branchless polynomial atan2 in degrees [0, 360) (the reference's
    fastAtan2): octant fold by |x|, |y|, the odd polynomial, quadrant
    unfolds; ~0.01 degree from the exact angle."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=y.device)
    ax, ay = x.abs(), y.abs()
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    c = lo / (hi + _ATAN2_EPS)
    c2 = c * c
    p1, p3, p5, p7 = _ATAN2_P
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


@at_x64_off
def atan2_deg_exact(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 in degrees [0, 360)."""
    d = torch.rad2deg(torch.atan2(_float(y), _float(x)))
    return torch.where(d < 0, d + 360.0, d)


@at_x64_off
def hypot_(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(x^2 + y^2); integer inputs give float32, as ``jnp.hypot``."""
    return torch.hypot(_float(x), _float(y))


def _ipow(v: torch.Tensor, p: int):
    """v^p by JAX's integer_pow order (binary powering); None for p = 0."""
    acc = None
    while p > 0:
        if p & 1:
            acc = v if acc is None else acc * v
        p >>= 1
        if p > 0:
            v = v * v
    return acc


def _moment(f: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, p: int,
            q: int) -> torch.Tensor:
    """sum(f * xs^p * ys^q), the products left to right."""
    t = f
    xp, yq = _ipow(xs, p), _ipow(ys, q)
    if xp is not None:
        t = t * xp
    if yq is not None:
        t = t * yq
    return t.sum()


def _grids(f: torch.Tensor):
    h, w = f.shape
    ys = torch.arange(h, dtype=torch.float32, device=f.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=f.device)[None, :]
    return xs.expand(h, w), ys.expand(h, w)


@at_x64_off
def image_moments(img: torch.Tensor, order: int = 2) -> dict:
    """Raw image moments m_pq, p + q <= ``order`` (reference moments
    kernels, base/math/compv_math_moments.cxx)."""
    f = img.to(torch.float32)
    xs, ys = _grids(f)
    return {f"m{p}{q}": _moment(f, xs, ys, p, q)
            for p in range(order + 1) for q in range(order + 1 - p)}


@at_x64_off
def hu_moments(img: torch.Tensor) -> torch.Tensor:
    """The first 4 Hu invariant moments, (4,) float32."""
    m = image_moments(img, 3)
    m00 = torch.clamp_min(m["m00"], 1e-9)
    cx = m["m10"] / m00
    cy = m["m01"] / m00
    f = img.to(torch.float32)
    xs, ys = _grids(f)
    xs, ys = xs - cx, ys - cy

    def nu(p, q):
        return _moment(f, xs, ys, p, q) / m00 ** (1 + (p + q) / 2.0)

    n20, n02, n11 = nu(2, 0), nu(0, 2), nu(1, 1)
    n30, n03, n21, n12 = nu(3, 0), nu(0, 3), nu(2, 1), nu(1, 2)
    d = n20 - n02
    a, b = n30 - 3 * n12, 3 * n21 - n03
    c, e = n30 + n12, n21 + n03
    h1 = n20 + n02
    h2 = d * d + 4 * (n11 * n11)
    h3 = a * a + b * b
    h4 = c * c + e * e
    return torch.stack([h1, h2, h3, h4])
