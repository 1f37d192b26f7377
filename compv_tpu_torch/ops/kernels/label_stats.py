"""Per-strip label histogram: the Hopper kernel (``csrc/label_stats.cu``)
that replaces ``compv_tpu/ops/pallas/label_stats.py:strip_label_counts``
(K5), and its plain PyTorch twin.

An (H, W) i32 label map (background < 0) is cut into strips of
``strip_rows`` rows. For strip s, ``records[s, 0, k]`` is its k-th smallest
distinct label and ``records[s, 1, k]`` that label's pixel count in the
strip, for ``k < used[s] = min(distinct, rounds)``; ``truncated[s]`` is 1
when the strip held more than ``rounds`` labels. The reference leaves the
slots from ``used[s]`` on uninitialized; here both versions write them as
0, and comparisons with the reference ignore them. Summing a label's counts
over the strips gives its area.

The twin keys every foreground pixel by (strip, label) in int64, takes
``torch.unique`` with counts, and ranks each key within its strip.

The kernel is a run-compressed bounded merge, one CTA a strip: it reads the
strip as a flat array, emits one (label, run length) key where a label
differs from its predecessor, and keeps a sorted list of the
``min(rounds, strip_rows * W) + 1`` smallest distinct labels with their
counts, into which it merges the keys (a bitonic sort in shared memory, a
prefix sum over equal labels) whenever its buffer fills; a run head first
tries a small hash table in shared memory, so that equal labels mostly meet
before the sort. Its shared memory is the buffer, the list and the table,
so any ``W`` and ``strip_rows`` are taken; a map of per-pixel distinct
labels is exact and only slower. Where the buffer and the list do not fit
in a block's shared memory (``min(rounds, strip_rows * W)`` above 11,519 on
an H100), the kernel's second form keeps them in a scratch tensor of
device memory, a slice a strip, so any ``rounds`` is taken too.

Dispatch has no fallback: CUDA tensors go to the kernel (built at first
use) or the call raises; CPU tensors go to the twin.
``strip_label_counts.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from compv_tpu_torch.ops.kernels import _build

__all__ = ["kernel_plan", "strip_label_counts", "strip_label_counts_ref"]

_lib = None
_STATIC_SMEM = 1024   # bound on the kernel's static shared memory, bytes


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("label_stats")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.compv_strip_label_counts.argtypes = [p, i, i, i, i, i, i, i, p,
                                                 p, p, p]
        lib.compv_strip_label_counts.restype = i
        lib.compv_strip_label_counts_global.argtypes = [p, i, i, i, i, i, i,
                                                        i, p, p, p, p, p]
        lib.compv_strip_label_counts_global.restype = i
        lib.compv_strip_step.argtypes = []
        lib.compv_strip_step.restype = i
        lib.compv_strip_slots.argtypes = []
        lib.compv_strip_slots.restype = i
        lib.compv_strip_smem_optin.argtypes = [i]
        lib.compv_strip_smem_optin.restype = i
        _lib = lib
    return _lib


def _check(labels, rounds: int, strip_rows: int) -> None:
    if not isinstance(labels, torch.Tensor) or labels.dtype != torch.int32:
        raise ValueError("labels must be an i32 tensor")
    if labels.ndim != 2:
        raise ValueError(f"labels must be (H, W), got {tuple(labels.shape)}")
    if rounds < 1 or strip_rows < 1:
        raise ValueError(f"rounds and strip_rows must be positive, got "
                         f"{rounds} and {strip_rows}")
    if labels.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {labels.device}")


def strip_label_counts_ref(labels: torch.Tensor, rounds: int = 256,
                           strip_rows: int = 8):
    """The twin: strip-keyed int64 keys, ``torch.unique`` with counts,
    ranks within each strip."""
    _check(labels, rounds, strip_rows)
    h, w = labels.shape
    dev = labels.device
    n_strips = -(-h // strip_rows)
    strip = (torch.arange(h, device=dev) // strip_rows)[:, None].expand(h, w)
    fg = labels >= 0
    keys = (strip[fg].to(torch.int64) << 32) | labels[fg].to(torch.int64)
    uniq, counts = torch.unique(keys, sorted=True, return_counts=True)
    ks = uniq >> 32
    distinct = torch.bincount(ks, minlength=n_strips)
    start = torch.cumsum(distinct, 0) - distinct
    rank = torch.arange(uniq.numel(), device=dev) - start[ks]
    keep = rank < rounds
    ks, rank = ks[keep], rank[keep]
    records = torch.zeros((n_strips, 2, rounds), dtype=torch.int32, device=dev)
    records[ks, 0, rank] = (uniq[keep] & 0xFFFFFFFF).to(torch.int32)
    records[ks, 1, rank] = counts[keep].to(torch.int32)
    return (records, torch.clamp(distinct, max=rounds).to(torch.int32),
            (distinct > rounds).to(torch.int32))


def kernel_plan(rounds: int, strip_rows: int, w: int, step: int,
                slots: int) -> tuple[int, int, int]:
    """(cap, buffer keys, dynamic shared memory in bytes) of the kernel:
    the list holds ``cap + 1`` pairs, ``cap = min(rounds, strip_rows * w)``
    (a strip has no more labels than pixels); the buffer is the power of two
    that takes the list and the ``step`` keys that can come between two
    flushes; the hash table has ``slots`` slots; 8 bytes each."""
    cap = min(rounds, strip_rows * w)
    buf_keys = max(64, 1 << (cap + step).bit_length())
    return cap, buf_keys, 8 * (buf_keys + cap + 1 + slots)


def strip_label_counts(labels: torch.Tensor, rounds: int = 256,
                       strip_rows: int = 8):
    """K5: (H, W) i32 labels (-1 = background) -> (records (S, 2, rounds)
    i32, used (S,) i32, truncated (S,) i32), S = ceil(H / strip_rows).

    On a CUDA tensor any ``W``, ``strip_rows`` and ``rounds`` are taken:
    where the plan's buffer and list do not fit in a block's shared memory,
    they go to a scratch tensor of ``S * (buffer keys + cap + 1)`` pairs of
    8 bytes."""
    _check(labels, rounds, strip_rows)
    if labels.device.type == "cpu":
        return strip_label_counts_ref(labels, rounds, strip_rows)
    h, w = labels.shape
    dev = labels.device
    n_strips = -(-h // strip_rows)
    records = torch.empty((n_strips, 2, rounds), dtype=torch.int32,
                          device=dev)
    used = torch.empty((n_strips,), dtype=torch.int32, device=dev)
    truncated = torch.empty((n_strips,), dtype=torch.int32, device=dev)
    if n_strips == 0 or w == 0:
        return records.zero_(), used.zero_(), truncated.zero_()
    lib = _kernel_lib()
    optin = lib.compv_strip_smem_optin(dev.index if dev.index is not None
                                       else torch.cuda.current_device())
    cap, buf_keys, smem = kernel_plan(rounds, strip_rows, w,
                                      lib.compv_strip_step(),
                                      lib.compv_strip_slots())
    labels = labels.contiguous()
    args = (labels.data_ptr(), h, w, strip_rows, n_strips, rounds, cap,
            buf_keys, records.data_ptr(), used.data_ptr(),
            truncated.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if smem + _STATIC_SMEM <= optin:
            rc = lib.compv_strip_label_counts(*args, stream)
        else:
            scratch = torch.empty((n_strips * (buf_keys + cap + 1),),
                                  dtype=torch.int64, device=dev)
            rc = lib.compv_strip_label_counts_global(
                *args, scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"compv_strip_label_counts launch failed: "
                           f"cudaError {rc}")
    strip_label_counts.launches += 1
    return records, used, truncated


strip_label_counts.launches = 0
