"""FAST strengths + 3x3 NMS: the Hopper kernel (``csrc/fast_kernel.cu``)
that replaces ``compv_tpu/ops/pallas/fast_kernel.py:fast_strengths_nms_pallas``
(K1), and its plain PyTorch twin.

The twin, ``_strengths_ref`` + ``_nms_ref``, mirrors the XLA path the JAX
detector runs (``compv_tpu/features/fast.py:_strengths_f32``, ``_nms_f32``)
op for op; the kernel reproduces it bit for bit by another route.

The kernel's route: adding a constant commutes with min and max, so the arc
windows run on the raw circle pixels (``max_s min_arc (c - p - t) = Mb - p
- t`` with ``Mb = max_s min_arc c``, and ``p - t - Md`` with ``Md = min_s
max_arc c`` for the darker side); two horizontally adjacent pixels share an
instruction as 16-bit lanes; the windows are trees of Hopper's three-way
DPX min / max; a block computes a 64 x 32 strength region for a 62 x 30
output tile (64 x 16 for small images) and runs NMS from shared memory.
What bounds it: bytes (one read, two f32 maps written) and packed integer
min / max of the same order, so a few microseconds at 720p.

The early-out, exact: for N >= 9 every arc of N contiguous circle points
holds ``k`` or ``k + 8`` for each ``k`` in 0..7 (the 16 - N <= 7 points it
leaves out are contiguous, so at most 6 apart, and ``k`` and ``k + 8`` are
8 apart). So a brighter arc needs ``A = min_k max(c[k], c[k+8]) > p + t``
and a darker one ``B = max_k min(c[k], c[k+8]) < p - t``; a pixel that
passes neither has strength exactly 0. The kernel computes a side only for
warp rows (64 pixels) in which some interior pixel passes that side's test;
``early_out_counts`` reports what it did, ``early_out_candidates`` is the
per-pixel test.

Dispatch has no fallback: a CUDA tensor goes to the kernel (built at first
use) or the call raises; a CPU tensor goes to the twin. Each launch is
counted under ``fast_kernel`` (``_build.launch_counts``), so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from compv_tpu_torch.ops.kernels import _build

__all__ = ["CIRCLE_OFFSETS", "geometry", "early_out_candidates",
           "early_out_counts", "fast_strengths_nms", "fast_strengths_and_nms"]

# (dy, dx) for the 16 circle pixels, reference order (fast_dete.cxx:221-238)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def geometry(h: int, w: int) -> tuple[int, int, int, int]:
    """The kernel's strength region a block (width, height: one pixel pair
    a lane, one row a warp and trip) and its output tile (the NMS ring
    off) for an (h, w) image: 32 rows, or 16 under 400,000 pixels, where
    too few blocks are in flight to hide a block's chain of latencies."""
    rows = 16 if h * w < 400000 else 32
    return 64, rows, 62, rows - 2


def _check_geometry() -> None:
    tiles = (ctypes.c_int * 4)()
    for shape in ((720, 1282), (412, 733), (1, 1), (400, 1000)):
        _geometry(*shape, tiles)
        if tuple(tiles) != geometry(*shape):
            raise RuntimeError(
                f"fast_kernel.cu tiles {shape} as {tuple(tiles)}, this "
                f"module says {geometry(*shape)}")


_lib = _build.Library("fast_kernel", check=_check_geometry)
_p, _i = ctypes.c_void_p, ctypes.c_int
_strengths_nms = _lib.entry("compv_fast_strengths_nms",
                            [_p, _p, _i, _i, _i, _i, _i, _i, _p],
                            counts="fast_kernel")
_strengths_and_nms = _lib.entry("compv_fast_strengths_and_nms",
                                [_p, _p, _p, _i, _i, _i, _i, _p],
                                counts="fast_kernel")
_early_out_counts = _lib.entry("compv_fast_early_out_counts",
                               [_p, _p, _p, _p, _i, _i, _i, _i, _p],
                               counts="fast_kernel")
_geometry = _lib.entry("compv_fast_geometry", [_i, _i, ctypes.POINTER(_i)],
                       restype=None)


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


def early_out_candidates(img: torch.Tensor, threshold: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) bool maps of the interior pixels that pass the brighter and
    the darker opposite-pair test; every other pixel has strength 0 at any
    N >= 9."""
    h, w = img.shape
    f = img.to(torch.int32)
    padded = F.pad(f, (3, 3, 3, 3))
    taps = [padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
            for dy, dx in CIRCLE_OFFSETS]
    a = b = None
    for k in range(8):
        hi = torch.maximum(taps[k], taps[k + 8])
        lo = torch.minimum(taps[k], taps[k + 8])
        a = hi if a is None else torch.minimum(a, hi)
        b = lo if b is None else torch.maximum(b, lo)
    inside = _interior(h, w, 3, img.device)
    return (a > f + threshold) & inside, (b + threshold < f) & inside


def _early_out_counts_ref(img: torch.Tensor, threshold: int) -> torch.Tensor:
    """The kernel's early-out modelled on its geometry: of the warp rows
    (``geometry(h, w)[0]`` strengths wide, from column ``bx * out_w - 1``) on
    interior image rows, how many were tested, left with neither side
    computed, had the brighter side computed, the darker side."""
    h, w = img.shape
    str_w, str_h, out_w, out_h = geometry(h, w)
    dev = img.device
    x0 = torch.arange(-(-w // out_w), device=dev) * out_w - 1
    gy = (torch.arange(-(-h // out_h), device=dev)[:, None] * out_h - 1
          + torch.arange(str_h, device=dev)[None, :]).reshape(-1)
    gy = gy[(gy >= 3) & (gy < h - 3)]

    def rows_any(cand):
        csum = F.pad(cand.to(torch.int64).cumsum(1), (1, 0))
        hit = csum[:, (x0 + str_w).clamp(0, w)] - csum[:, x0.clamp(0, w)]
        return hit[gy] > 0

    brighter, darker = (rows_any(c) for c in
                        early_out_candidates(img, threshold))
    return torch.stack([torch.tensor(brighter.numel(), device=dev),
                        (~brighter & ~darker).sum(), brighter.sum(),
                        darker.sum()]).to(torch.int64)


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


def fast_strengths_nms(img: torch.Tensor, threshold: int = 20, n: int = 9,
                       nms: bool = True, interpret: bool = False,
                       as_f32: bool = False) -> torch.Tensor:
    """(H, W) u8 -> (H, W) FAST-n strengths map, with strict 3x3 NMS when
    ``nms``; u8, or f32 when ``as_f32``. K1's signature and output types;
    ``interpret`` (Pallas's interpreter) is accepted and ignored."""
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
    _strengths_nms.launch(img.device, img.data_ptr(), out.data_ptr(), h, w,
                          int(threshold), n, int(nms), int(as_f32))
    return out


def fast_strengths_and_nms(img: torch.Tensor, threshold: int = 20, n: int = 9
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) u8 -> (strengths f32, NMS strengths f32) from one launch: the
    ORB level loop needs the raw map for its sub-pixel fit and the NMS map
    for selection."""
    _check(img, threshold, n)
    if img.device.type == "cpu":
        s = _strengths_ref(img, threshold, n)
        return s, _nms_ref(s)
    h, w = img.shape
    raw = torch.empty((h, w), dtype=torch.float32, device=img.device)
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if h * w == 0:
        return raw, out
    _strengths_and_nms.launch(img.device, img.data_ptr(), raw.data_ptr(),
                              out.data_ptr(), h, w, int(threshold), n)
    return raw, out


def early_out_counts(img: torch.Tensor, threshold: int = 20, n: int = 9
                     ) -> torch.Tensor:
    """(4,) int64: the warp rows the kernel's early-out tested on ``img``,
    those it left with neither side computed, those whose brighter side it
    computed and those whose darker side. On the card the kernel counts
    them itself while it computes both maps (one launch); a CPU tensor goes
    to the model of the kernel's geometry."""
    _check(img, threshold, n)
    if img.device.type == "cpu":
        return _early_out_counts_ref(img, int(threshold))
    h, w = img.shape
    counts = torch.zeros((4,), dtype=torch.int64, device=img.device)
    if h * w == 0:
        return counts
    raw = torch.empty((h, w), dtype=torch.float32, device=img.device)
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    _early_out_counts.launch(img.device, img.data_ptr(), raw.data_ptr(),
                             out.data_ptr(), counts.data_ptr(), h, w,
                             int(threshold), n)
    return counts
