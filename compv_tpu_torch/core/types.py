"""Core result containers: fixed-capacity, masked NamedTuples of tensors,
and the reference's dtype rule at the port's public entries.

Mirror of ``compv_tpu/core/types.py``: the same fields, capacities and
``valid`` masks, so the two packages compare field by field.

The dtype contract: the port returns what the reference returns with
JAX's 64-bit mode off (its default, and the TPU's). There a float64 array
is float32 and an int64 one int32 from the moment it reaches JAX, so the
reference never computes in 64 bits. ``x64_off`` applies that rule to a
value and ``at_x64_off`` to every argument of a public entry point; work
that the port does in float64 on purpose (the Schur step, ``platt_fit``)
runs below those entries.
"""
from __future__ import annotations

import functools
import inspect
from typing import NamedTuple

import torch

__all__ = ["Keypoints", "Lines", "Matches", "is_integer_dtype",
           "x64_off_dtype", "x64_off", "at_x64_off", "float_points"]

_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def is_integer_dtype(dtype: torch.dtype) -> bool:
    """``jnp.issubdtype(dtype, jnp.integer)``: an integer dtype, not bool."""
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def x64_off_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype JAX holds ``dtype`` as with 64-bit mode off: float64 ->
    float32, int64 -> int32, uint64 -> uint32, complex128 -> complex64."""
    return _X64_OFF.get(dtype, dtype)


def x64_off(x):
    """``x`` as the reference holds it with 64-bit mode off: each 64-bit
    tensor cast to its 32-bit dtype (``x64_off_dtype``), through tuples,
    lists and NamedTuples; anything else unchanged."""
    if isinstance(x, torch.Tensor):
        dt = _X64_OFF.get(x.dtype)
        return x if dt is None else x.to(dt)
    if isinstance(x, (tuple, list)):
        out = [x64_off(v) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*out)
        return type(x)(out)
    return x


def at_x64_off(fn=None, *, floats: tuple = ()):
    """Decorator of a public entry point: ``x64_off`` of every argument
    (tensors and tuples of them; dtypes, numbers and configs pass as
    they are), and ``float_points`` of the tensor parameters named in
    ``floats``: the coordinates, matrices and poses that the reference's
    float arithmetic promotes to float32 when they come as integers."""
    if fn is None:
        return functools.partial(at_x64_off, floats=floats)
    names = list(inspect.signature(fn).parameters)
    where = {names.index(n) for n in floats}
    if len(where) != len(floats):
        raise ValueError(f"{fn.__name__} has no parameter among {floats}")

    def conv(v, promote: bool):
        v = x64_off(v)
        return float_points(v) if promote and isinstance(
            v, torch.Tensor) else v

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        return fn(*[conv(a, i in where) for i, a in enumerate(args)],
                  **{k: conv(v, k in floats) for k, v in kwargs.items()})
    return entry


def float_points(x: torch.Tensor) -> torch.Tensor:
    """Coordinates as the reference's float arithmetic makes them: an
    integer or bool tensor promoted to float32 (``jnp``'s promotion of an
    integer array against a Python float), float32 left as it is."""
    return x if x.dtype.is_floating_point else x.to(torch.float32)


class Keypoints(NamedTuple):
    """Fixed-capacity set of interest points; entries with ``valid == False``
    are padding (reference CompVInterestPoint as a struct of arrays)."""

    x: torch.Tensor            # (K,) f32 — level-0 pixel coords
    y: torch.Tensor            # (K,) f32
    strength: torch.Tensor     # (K,) f32 — detector response
    orientation: torch.Tensor  # (K,) f32 — degrees [0, 360)
    level: torch.Tensor        # (K,) i32 — pyramid level
    size: torch.Tensor         # (K,) f32 — patch diameter at level 0
    valid: torch.Tensor        # (K,) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    @staticmethod
    def empty(capacity: int, device=None) -> "Keypoints":
        z = torch.zeros((capacity,), dtype=torch.float32, device=device)
        return Keypoints(
            x=z, y=z, strength=z, orientation=z,
            level=torch.zeros((capacity,), dtype=torch.int32, device=device),
            size=torch.full((capacity,), 7.0, dtype=torch.float32,
                            device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def _take(self, idx: torch.Tensor) -> "Keypoints":
        """Gather every field at ``idx`` along the keypoint axis."""
        return Keypoints(*[f.index_select(-1, idx) for f in self])

    def select_best(self, k: int) -> "Keypoints":
        """The ``k`` strongest points, sorted by decreasing strength (ties:
        lower index first, as ``lax.top_k``)."""
        from compv_tpu_torch.ops.topk import top_k
        s = torch.where(self.valid, self.strength,
                        torch.full_like(self.strength, -torch.inf))
        _, idx = top_k(s, k)
        return self._take(idx)

    def erase_near_border(self, width: int, height: int,
                          border_x: float, border_y: float) -> "Keypoints":
        """Invalidate points whose patch crosses the image border."""
        ok = ((self.x >= border_x) & (self.y >= border_y)
              & (self.x < width - border_x) & (self.y < height - border_y))
        return self._replace(valid=self.valid & ok)


class Matches(NamedTuple):
    """KNN match result in the dense (K, Nq) layout of the reference
    matcher's output Mat."""

    train_idx: torch.Tensor  # (K, Nq) i32
    distance: torch.Tensor   # (K, Nq) f32 (Hamming distance is integral)
    valid: torch.Tensor      # (K, Nq) bool


class Lines(NamedTuple):
    """Fixed-capacity set of polar lines (rho, theta, strength): the output
    of the Hough transforms (reference CompVHoughLine)."""

    rho: torch.Tensor       # (L,) f32
    theta: torch.Tensor     # (L,) f32 radians
    strength: torch.Tensor  # (L,) f32
    valid: torch.Tensor     # (L,) bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)
