"""Ragged row compaction: the Hopper kernel (``csrc/compact_kernel.cu``)
that replaces ``compv_tpu/ops/pallas/compact_kernel.py:compact_rows`` (K3),
and its plain PyTorch twin.

Each row i of two aligned (H, K) i32 record tables owns ``counts[i]`` valid
records in its first slots. Row i's first ceil(min(counts[i], K) / 8) * 8
records go to its exclusive-prefix-sum offset in two flat (cap8 * 8,)
outputs; ``total`` is the 8-aligned ragged total and ``ok`` says whether it
fits. Records past a row's count but inside its 8-aligned copy come from
the input (callers pre-fill sentinels); slots at or past ``total`` are not
written: the caller masks them. When ``ok`` is False the offsets are
clamped so that every write stays in bounds, and the frame is to be
discarded; only the slots before ``(cap8 - K / 8) * 8`` are then defined,
since later ones may be overwritten by the clamped rows.

The JAX wrapper computes the offsets (the prefix sum of the chunk counts,
the clamp, ``total`` and ``ok``) beside its kernel, and ``jax.jit`` fuses
those lines into the program around it. Eager PyTorch has no such fusion:
sent from Python they were about 13 small launches around one copy. So
the kernel computes them itself, and ``compact_rows`` on a CUDA tensor is
one device operation: check, ``torch.empty``, launch. The twin keeps the
offsets as tensor code (``_offsets``) plus an indexed copy in which, where
clamped rows overlap, the later row wins (the TPU kernel's sequential grid
order).

Dispatch has no fallback: CUDA tensors go to the kernel (built at first
use) or the call raises; CPU tensors go to the twin. Its launches are
counted under ``compact`` (``_build.launch_counts``).
"""
from __future__ import annotations

import ctypes

import torch

from compv_tpu_torch.ops.kernels import _build

__all__ = ["compact_rows", "compact_ref"]

_p, _i = ctypes.c_void_p, ctypes.c_int
_compact = _build.Library("compact_kernel").entry(
    "compv_compact_rows", [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    counts="compact")


def _check(a, b, counts, cap8) -> None:
    for name, t in (("a", a), ("b", b), ("counts", counts)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an i32 tensor")
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"a and b must be (H, K) tables of one shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    h, k = a.shape
    if k % 8 or k == 0:
        raise ValueError(f"record width must be a positive multiple of 8, "
                         f"got {k}")
    if tuple(counts.shape) != (h,):
        raise ValueError(f"counts must be ({h},), got {tuple(counts.shape)}")
    if cap8 < max(k // 8, 1):
        raise ValueError(f"cap8 must hold one full row ({k // 8} chunks), "
                         f"got {cap8}")
    if not a.device == b.device == counts.device:
        raise ValueError("a, b and counts must be on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _offsets(counts: torch.Tensor, k: int, cap8: int):
    """(nch, clamped off8, total, ok), as ``compact_kernel.py:57-69``."""
    nch = (torch.clamp(counts, max=k) + 7) // 8
    off8 = torch.cumsum(nch, 0, dtype=torch.int32) - nch
    total8 = (off8[-1] + nch[-1]) if counts.numel() else nch.sum()
    ok = total8 <= cap8
    # clamp so an overflowing frame still writes in bounds (ok=False tells
    # the caller to discard it)
    off8 = torch.minimum(off8, cap8 - torch.clamp(nch, min=1))
    off8 = torch.clamp(off8, min=0).to(torch.int32)
    return nch.to(torch.int32), off8, (total8 * 8).to(torch.int32), ok


def compact_ref(a: torch.Tensor, b: torch.Tensor, counts: torch.Tensor,
                cap8: int):
    """The twin: prefix-sum offsets and an indexed copy. Unwritten slots
    hold 0."""
    _check(a, b, counts, cap8)
    h, k = a.shape
    nch, off8, total, ok = _offsets(counts, k, cap8)
    j = torch.arange(k, dtype=torch.int64, device=a.device)
    take = j[None, :] < (nch.to(torch.int64) * 8)[:, None]       # (H, K)
    dest = (off8.to(torch.int64) * 8)[:, None] + j[None, :]
    dest = dest[take]
    # later rows win where clamped rows overlap
    order = torch.arange(dest.numel(), dtype=torch.int64, device=a.device)
    winner = torch.full((cap8 * 8,), -1, dtype=torch.int64, device=a.device)
    winner.scatter_reduce_(0, dest, order, reduce="amax")
    written = winner >= 0
    outs = []
    for t in (a, b):
        out = torch.zeros((cap8 * 8,), dtype=torch.int32, device=a.device)
        out[written] = t[take][winner[written]]
        outs.append(out)
    return outs[0], outs[1], total, ok


def compact_rows(a: torch.Tensor, b: torch.Tensor, counts: torch.Tensor,
                 cap8: int, rows_per_step: int = 8):
    """K3: compact two aligned (H, K) i32 record tables by their per-row
    valid counts. Returns (a_flat (cap8*8,), b_flat (cap8*8,), total () i32,
    ok () bool). ``rows_per_step`` (rows a step of the Pallas grid) is
    accepted and ignored: K3 takes a row a warp."""
    _check(a, b, counts, cap8)
    if a.device.type == "cpu":
        return compact_ref(a, b, counts, cap8)
    h, k = a.shape
    a, b, counts = a.contiguous(), b.contiguous(), counts.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("record tables must be 16-byte aligned")
    oa = torch.empty((cap8 * 8,), dtype=torch.int32, device=a.device)
    ob = torch.empty((cap8 * 8,), dtype=torch.int32, device=a.device)
    if h == 0:
        _, _, total, ok = _offsets(counts, k, cap8)
        return oa, ob, total, ok
    total = torch.empty((), dtype=torch.int32, device=a.device)
    ok = torch.empty((), dtype=torch.bool, device=a.device)
    _compact.launch(a.device, a.data_ptr(), b.data_ptr(), counts.data_ptr(),
                    oa.data_ptr(), ob.data_ptr(), total.data_ptr(),
                    ok.data_ptr(), h, k, cap8)
    return oa, ob, total, ok
