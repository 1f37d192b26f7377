"""FAST strengths + 3x3 NMS: the Hopper kernel (``csrc/fast_kernel.cu``)
that replaces ``compv_tpu/ops/pallas/fast_kernel.py:fast_strengths_nms_pallas``
(K1), and its plain PyTorch twin.

The twin, ``_strengths_ref`` + ``_nms_ref``, mirrors the XLA path the JAX
detector runs (``compv_tpu/features/fast.py:_strengths_f32``, ``_nms_f32``)
op for op; the kernel reproduces it bit for bit.

Dispatch has no fallback: a CUDA tensor goes to the kernel (built at first
use) or the call raises; a CPU tensor goes to the twin. ``launches`` counts
the kernel's launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from compv_tpu_torch.ops.kernels import _build

__all__ = ["CIRCLE_OFFSETS", "fast_strengths_nms", "fast_strengths_and_nms"]

# (dy, dx) for the 16 circle pixels, reference order (fast_dete.cxx:221-238)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

# kernel launches since the counter was last set to 0
launches = 0

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fast_kernel")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.compv_fast_strengths_nms.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.compv_fast_strengths_nms.restype = i
        lib.compv_fast_strengths_and_nms.argtypes = [p, p, p, i, i, i, i, p]
        lib.compv_fast_strengths_and_nms.restype = i
        _lib = lib
    return _lib


def _interior(h: int, w: int, border: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return ((yy >= border) & (yy < h - border)
            & (xx >= border) & (xx < w - border))


def _strengths_ref(img: torch.Tensor, threshold: int, n: int) -> torch.Tensor:
    """Dense FAST-n strengths (H, W) f32 of exact small integers, zero
    outside the 3-px border. Signed diffs, circular-window minima by
    doubling over the running-min list, one final relu."""
    h, w = img.shape
    f = img.to(torch.float32)
    padded = F.pad(f, (3, 3, 3, 3))
    brighter = f + float(threshold)
    darker = f - float(threshold)
    d_list, b_list = [], []
    for dy, dx in CIRCLE_OFFSETS:
        c = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        d_list.append(darker - c)
        b_list.append(c - brighter)

    def arc_strength(vals):
        m = list(vals)
        span = 1
        while span < n:
            step = min(span, n - span)
            m = [torch.minimum(m[k], m[(k + step) % 16]) for k in range(16)]
            span += step
        out = m[0]
        for k in range(1, 16):
            out = torch.maximum(out, m[k])
        return out

    strength = torch.maximum(arc_strength(d_list), arc_strength(b_list))
    strength = strength.clamp_min(0.0)
    return torch.where(_interior(h, w, 3, img.device), strength, 0.0)


def _nms_ref(s: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 NMS on an f32 strengths map: keep s where s > 0 and all 8
    neighbours (0 outside the image) are smaller; applied in [3, dim-3)."""
    h, w = s.shape
    padded = F.pad(s, (1, 1, 1, 1))
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            v = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            nmax = v if nmax is None else torch.maximum(nmax, v)
    keep = (s > 0) & (nmax < s)
    return torch.where(keep & _interior(h, w, 3, s.device), s, 0.0)


def _check(img: torch.Tensor, threshold: int, n: int) -> None:
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(img).__name__}")
    if img.dtype != torch.uint8 or img.ndim != 2:
        raise ValueError("expected a 2-D uint8 image, got "
                         f"{img.ndim}-D {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("expected a contiguous image")
    if n not in (9, 12):
        raise ValueError(f"n must be 9 or 12, got {n}")
    if int(threshold) != threshold or not 0 <= threshold <= 255:
        raise ValueError(f"threshold must be an integer in [0, 255], "
                         f"got {threshold}")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def fast_strengths_nms(img: torch.Tensor, threshold: int = 20, n: int = 9,
                       nms: bool = True, as_f32: bool = False
                       ) -> torch.Tensor:
    """(H, W) u8 -> (H, W) FAST-n strengths map, with strict 3x3 NMS when
    ``nms``; u8, or f32 when ``as_f32``. K1's signature and output types."""
    global launches
    _check(img, threshold, n)
    if img.device.type == "cpu":
        s = _strengths_ref(img, threshold, n)
        if nms:
            s = _nms_ref(s)
        return s if as_f32 else s.to(torch.uint8)
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32 if as_f32 else torch.uint8,
                      device=img.device)
    if h * w == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(img.device):
        rc = lib.compv_fast_strengths_nms(
            img.data_ptr(), out.data_ptr(), h, w, int(threshold), n, int(nms),
            int(as_f32), _stream_ptr(img.device))
    _raise_on(rc, "compv_fast_strengths_nms")
    launches += 1
    return out


def fast_strengths_and_nms(img: torch.Tensor, threshold: int = 20, n: int = 9
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) u8 -> (strengths f32, NMS strengths f32) from one launch: the
    ORB level loop needs the raw map for its sub-pixel fit and the NMS map
    for selection."""
    global launches
    _check(img, threshold, n)
    if img.device.type == "cpu":
        s = _strengths_ref(img, threshold, n)
        return s, _nms_ref(s)
    h, w = img.shape
    raw = torch.empty((h, w), dtype=torch.float32, device=img.device)
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if h * w == 0:
        return raw, out
    lib = _kernel_lib()
    with torch.cuda.device(img.device):
        rc = lib.compv_fast_strengths_and_nms(
            img.data_ptr(), raw.data_ptr(), out.data_ptr(), h, w,
            int(threshold), n, _stream_ptr(img.device))
    _raise_on(rc, "compv_fast_strengths_and_nms")
    launches += 1
    return raw, out
