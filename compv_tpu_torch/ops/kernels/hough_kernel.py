"""SHT vote accumulator: the Hopper kernel (``csrc/hough_kernel.cu``) that
replaces ``compv_tpu/ops/pallas/hough_kernel.py:sht_accumulate_pallas``
(K4), and its plain PyTorch twin.

For every edge point and every theta row, the weight of the point goes to
rho bin ``round_half_even((cos*x + sin*y + rho_max) / rho_step)``, clipped
to ``[0, n_rho)``, with ``n_rho = ceil(2 rho_max / rho_step) + 1``; the twin
is ``_rho_bins`` then ``batched_weighted_bincount`` (``hough.py:106-109``).

The f32 arithmetic is the reference's as ``hough_sht`` runs it: jitted on
XLA:CPU, which fuses the expression. There ``cos*x + sin*y`` is one fused
multiply-add, ``fma(cos, x, sin*y)``, and the division by the constant
``rho_step`` is a multiplication by its f32 reciprocal; the Pallas kernel
in interpret mode computes the same. (Run op by op, outside ``jit``, the
reference's ``_rho_bins`` rounds the products separately and divides:
ROADMAP.md Queue 3.) Both versions here take the reference's trig table
(``features/hough_trig.py``); the twin forms the fused multiply-add exactly
(``fma_f32``) and keeps its f32 scalars as tensors on the input's device,
since a CUDA operation with a Python scalar may round otherwise.

The Pallas kernel counts a weight ``> 0`` as one vote; the XLA twin and
this port add integer weights (the reference's only caller passes 0/1).

The kernel is theta-blocked and edge-split: a CTA loads one S-th of the
edge list once, with independent 16-byte loads into registers, and votes
for a block of T thetas into T histograms in shared memory; the S CTAs of a
thread-block cluster then sum their partial histograms through distributed
shared memory, each writing its slice of the accumulator, so every element
is written once and a call is one device operation. What bounds it is
latency, not bytes (under a microsecond of HBM time at 720p): the design
removes the chain of dependent L2 loads and the re-reading of the list
once a theta. Where a theta row of ``n_rho`` bins is more than a block's
shared memory (some 58,000 bins on an H100), a CTA owns a rho range of its
thetas and the grid gains a rho-tile dimension, so any ``n_rho`` is taken.
``sht_plan`` gives the T, S and rho tiles the kernel takes for a shape.

Dispatch has no fallback: CUDA tensors go to the kernel (built at first
use) or the call raises; CPU tensors go to the twin. Its launches are
counted under ``sht_accumulate`` (``_build.launch_counts``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from compv_tpu_torch.ops.bincount import batched_weighted_bincount
from compv_tpu_torch.ops.kernels import _build

__all__ = ["fma_f32", "n_rho_bins", "rho_bins", "sht_accumulate",
           "sht_accumulate_ref", "sht_plan"]

_lib = _build.Library("hough_kernel")
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_accumulate = _lib.entry("compv_sht_accumulate",
                         [_p, _p, _p, _p, _p, _p, _i, _i, _i, _f, _f, _p],
                         counts="sht_accumulate")
_smem_optin = _lib.entry("compv_sht_smem_optin", [_i])
_plan = _lib.entry("compv_sht_plan", [_i, _i, ctypes.POINTER(_i)])


def n_rho_bins(rho_max: float, rho_step: float) -> int:
    """Accumulator width, computed in float64 as ``hough.py:79``."""
    return int(np.ceil(2 * rho_max / rho_step)) + 1


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _reciprocal(rho_step: float) -> np.float32:
    """The f32 reciprocal XLA multiplies by in place of ``/ rho_step``."""
    return np.float32(1) / np.float32(rho_step)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` of f32 tensors with one rounding to f32, as a fused
    multiply-add (broadcasting). ``a * b`` is exact in float64; the float64
    sum is exact up to its TwoSum error ``e``, which matters only where the
    sum lands on the midpoint of two f32 values: there ``e`` breaks the
    tie."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - c64
    e = (p - bp) + (c64 - (s - bp))
    f = s.to(torch.float32)
    fd = f.double()
    inf = torch.full_like(f, torch.inf)
    other = torch.where(s > fd, torch.nextafter(f, inf),
                        torch.nextafter(f, -inf))
    mid = (s != fd) & ((fd + other.double()) * 0.5 == s) & (e != 0)
    tie = torch.where(e > 0, torch.maximum(f, other), torch.minimum(f, other))
    return torch.where(mid, tie, f)


def rho_bins(x: torch.Tensor, y: torch.Tensor, cos_t: torch.Tensor,
             sin_t: torch.Tensor, rho_max: float, rho_step: float
             ) -> torch.Tensor:
    """i32 rho bin of points (x, y) at angles (cos_t, sin_t), all four
    broadcast together (``hough.py:78-81``; the KHT votes of ``:296-298``
    are the elementwise case): ``rint((fma(cos, x, sin*y) + rho_max) *
    f32(1 / rho_step))``, clipped."""
    rho = fma_f32(cos_t, x, sin_t * y)
    dev = x.device
    rbin = torch.round((rho + _f32(rho_max, dev))
                       * _f32(_reciprocal(rho_step), dev)).to(torch.int32)
    return rbin.clamp_(0, n_rho_bins(rho_max, rho_step) - 1)


def _check(x, y, w, n_theta, cos_t, sin_t) -> None:
    for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                        ("w", w, torch.int32), ("cos_t", cos_t, torch.float32),
                        ("sin_t", sin_t, torch.float32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D {dt} tensor")
    if not x.shape == y.shape == w.shape:
        raise ValueError(f"x, y and w must have one shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(w.shape)}")
    if not cos_t.shape == sin_t.shape == (n_theta,):
        raise ValueError(f"cos_t and sin_t must be ({n_theta},)")
    if not x.device == y.device == w.device == cos_t.device == sin_t.device:
        raise ValueError("all inputs must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def sht_accumulate_ref(x, y, w, n_theta: int, rho_max: float,
                       rho_step: float, cos_t, sin_t) -> torch.Tensor:
    """The twin: rho bins of every (theta, point) pair, then a per-theta
    weighted bincount. Returns (n_theta, n_rho) i32."""
    _check(x, y, w, n_theta, cos_t, sin_t)
    rbin = rho_bins(x[None, :], y[None, :], cos_t[:, None],
                    sin_t[:, None], rho_max, rho_step)
    return batched_weighted_bincount(rbin, w.expand(n_theta, -1),
                                     n_rho_bins(rho_max, rho_step))


def sht_plan(n_theta: int, n_rho: int, device) -> tuple[int, int, int]:
    """(T, S, tiles): the thetas a CTA votes for, the CTAs a cluster (the
    split of the edge list) and the rho tiles (1 where a CTA holds whole
    theta rows) that the kernel takes for an ``(n_theta, n_rho)``
    accumulator on the CUDA ``device``."""
    ts = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = _plan(n_theta, n_rho, ts)
    if rc != 0:
        raise RuntimeError(f"compv_sht_plan failed: cudaError {rc}")
    return ts[0], ts[1], ts[2]


def sht_accumulate(x, y, w, n_theta: int, rho_max: float, rho_step: float,
                   cos_t, sin_t) -> torch.Tensor:
    """K4: (E,) f32 x, y and (E,) i32 weights -> (n_theta, n_rho) i32
    accumulator at the angles of the (n_theta,) f32 table ``cos_t`` /
    ``sin_t``, in one kernel that writes every element. The reference's
    ``theta_step``, ``w_img`` and ``h_img`` served its own trig table and
    per-theta rho window; this kernel takes the table and needs no
    window."""
    _check(x, y, w, n_theta, cos_t, sin_t)
    if x.device.type == "cpu":
        return sht_accumulate_ref(x, y, w, n_theta, rho_max, rho_step,
                                  cos_t, sin_t)
    n_rho = n_rho_bins(rho_max, rho_step)
    dev = x.device
    x, y, w = x.contiguous(), y.contiguous(), w.contiguous()
    cos_t, sin_t = cos_t.contiguous(), sin_t.contiguous()
    acc = torch.empty((n_theta, n_rho), dtype=torch.int32, device=dev)
    if n_theta == 0:
        return acc
    _accumulate.launch(dev, x.data_ptr(), y.data_ptr(), w.data_ptr(),
                       cos_t.data_ptr(), sin_t.data_ptr(), acc.data_ptr(),
                       x.numel(), n_theta, n_rho, float(np.float32(rho_max)),
                       float(_reciprocal(rho_step)))
    return acc
