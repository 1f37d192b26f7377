"""MSER ladder level areas: the Hopper kernel ``level_areas``
(``csrc/level_areas.cu``, K7), which replaces no TPU kernel, and its plain
PyTorch twin.

One level of MSER's gray-level ladder hands its (H, W) i32 labels (the
minimum flat index of each pixel's component, -1 at background) to
``level_candidates``, which writes the level's candidate table in place:
the roots of the components of at least ``amin`` pixels in ascending root
order, the first ``cap`` of them, then -1; their pixel counts, then 0; and
an overflow flag, 1 when more than ``cap`` components qualify.

The twin is the JAX ladder's area chain (``compv_tpu/features/mser.py``):
run records (``extract_runs``) at the smallest run-capacity tier that
covers the level's widest row, grouped by one sort of packed
(label << len_bits | len) keys, segment sums by a cumsum and a reversed
cummin, a stable sort to compact. On the card that chain is ~115 launches
and a host read (the tier) a level; the kernel counts pixels by label into
a scratch table and compacts it in three launches and no host read, and
equals the twin bit for bit. One deviation, in the kernel's favour: where
the twin's exact tier is clamped by its int32 bound on the sum of run
lengths (H * W * ceil(W / 2) >= 2^31), the twin clips runs and sets the
flag, where the kernel counts every pixel; there the flag can only fall.

Dispatch has no fallback: CUDA tensors go to the kernel (built at first
use) or the call raises; CPU tensors go to the twin. ``launches`` counts
the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from compv_tpu_torch.features.ccl import extract_runs
from compv_tpu_torch.ops.kernels import _build

__all__ = ["level_candidates", "run_tiers", "scratch"]

_BIG = 1 << 30
_U32_SENT = 0xFFFFFFFF
_MAX_PIXELS = 1 << 30   # labels and their roots stay below 2^30

# kernel launches since the counter was last set to 0
launches = 0

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("level_areas")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.compv_level_areas.argtypes = [p, i, i, i, p, p, p, p, p]
        lib.compv_level_areas.restype = i
        lib.compv_level_areas_scratch.argtypes = [i]
        lib.compv_level_areas_scratch.restype = i
        _lib = lib
    return _lib


def run_tiers(h: int, w: int, tiers=(112, 320)) -> list:
    """The twin's per-row run-record capacities for an (h, w) image,
    ascending and ending in the exact ceil(w / 2) tier (clamped only where
    the int32 bound on the sum of run lengths forbids it)."""
    w_exact = -(-w // 2)
    sum_cap = max((2 ** 31 - 1) // (h * max(w, 1)), 1)
    return sorted({min(t, w_exact, sum_cap) for t in tiers}
                  | {min(w_exact, sum_cap)})


def _level_candidates(lbl, kk, amin, cap, lb_bits, len_bits):
    """Exact per-component areas of one level's labeling via run records,
    compacted to the (cap,) candidate table of components with area >=
    min_area, in ascending root order. Returns (root, area, over)."""
    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, kk)
    over_runs = (counts > kk).any()
    live = run_lbl >= 0
    length = torch.where(live, run_x1 - run_x0 + 1, 0)
    # one packed key sort: label groups, the length rides in the low bits
    # (int64 keys: no separate form when lb_bits + len_bits > 32)
    keyu = torch.where(live, (run_lbl.to(torch.int64) << len_bits)
                       | length.to(torch.int64), _U32_SENT).reshape(-1)
    ku = torch.sort(keyu).values
    sen = ku == _U32_SENT
    ks = torch.where(sen, _BIG, ku >> len_bits)
    ln = torch.where(sen, 0, ku & ((1 << len_bits) - 1))
    is_first = (ks != F.pad(ks, (1, 0), value=-1)[:-1]) & (ks < _BIG)
    cs = torch.cumsum(ln, 0)
    exc = F.pad(cs, (1, 0))[:-1]
    u = torch.where(is_first, exc, 2 ** 62)
    nxt = torch.cummin(u.flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt[1:], cs[-1:]])
    area = torch.minimum(nxt, cs[-1]) - exc             # valid at is_first

    cand_mask = is_first & (area >= amin)
    ckey = torch.where(cand_mask, ks, _BIG)
    root_s, order = torch.sort(ckey, stable=True)
    area_s = torch.where(cand_mask, area, 0)[order]
    root = torch.where(root_s[:cap] < _BIG, root_s[:cap], -1)
    car = torch.where(root >= 0, area_s[:cap], 0)
    over = (over_runs | (cand_mask.sum() > cap)).to(torch.int32)
    return root.to(torch.int32), car.to(torch.int32), over


def _level_candidates_ref(lbl, amin, cap, tiers=(112, 320)):
    """The twin: the run-record chain at the smallest of ``run_tiers``
    that holds the level's widest row (a host read of that width), its
    table padded to ``cap`` where the level has fewer run slots."""
    h, w = lbl.shape
    n = h * w
    tiers = run_tiers(h, w, tiers)
    fgl = lbl >= 0
    starts = fgl & ~F.pad(fgl, (1, 0), value=False)[:, :-1]
    mx = int(starts.sum(dim=1).max()) if h else 0
    kk = tiers[sum(int(mx > t_) for t_ in tiers[:-1])]
    root, car, over = _level_candidates(lbl, kk, amin, cap,
                                        max(1, (n - 1).bit_length()),
                                        max(1, w.bit_length()))
    short = cap - root.numel()
    return F.pad(root, (0, short), value=-1), F.pad(car, (0, short)), over


def scratch(n: int, device) -> torch.Tensor:
    """The zeroed i32 buffer the kernel counts the areas of n labels into;
    each call leaves it zeroed, so one serves every level of an image.
    Empty off the card, where the twin needs none."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.zeros((0,), dtype=torch.int32, device=device)
    size = _kernel_lib().compv_level_areas_scratch(n)
    return torch.zeros((size,), dtype=torch.int32, device=device)


def _check(lbl, amin, cap, root, area, over, buf) -> None:
    for name, t in (("lbl", lbl), ("root", root), ("area", area),
                    ("over", over)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if lbl.ndim != 2:
        raise ValueError(f"lbl: expected a 2-D label map, got {lbl.ndim}-D")
    if lbl.numel() >= _MAX_PIXELS:
        raise ValueError(f"{tuple(lbl.shape)} labels: fewer than 2^30 pixels "
                         "expected")
    for name, v in (("cap", cap), ("amin", amin)):
        if isinstance(v, bool) or not isinstance(v, int) or v < 1:
            raise ValueError(f"{name} must be an int >= 1, got {v!r}")
    for name, t in (("root", root), ("area", area)):
        if t.shape != (cap,):
            raise ValueError(f"{name}: expected shape ({cap},), got "
                             f"{tuple(t.shape)}")
    if over.numel() != 1:
        raise ValueError(f"over: expected one element, got {over.numel()}")
    if not lbl.device == root.device == area.device == over.device:
        raise ValueError("lbl, root, area and over must be on one device")
    if lbl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lbl.device}")
    if buf is not None and lbl.device.type == "cuda":
        if (not isinstance(buf, torch.Tensor) or buf.dtype != torch.int32
                or buf.ndim != 1 or not buf.is_contiguous()
                or buf.device != lbl.device or buf.data_ptr() % 16):
            raise ValueError("scratch: expected a contiguous, 16-byte "
                             "aligned 1-D int32 tensor on the labels' "
                             "device, as scratch() makes it")


def level_candidates(lbl: torch.Tensor, amin: int, cap: int,
                     root: torch.Tensor, area: torch.Tensor,
                     over: torch.Tensor, buf: torch.Tensor | None = None,
                     tiers=(112, 320)) -> None:
    """One ladder level's candidate table from its (H, W) i32 labels,
    written in place: ``root`` (cap,) the labels of at least ``amin``
    pixels, ascending, then -1; ``area`` (cap,) their pixel counts, then
    0; ``over`` (one element) 1 where more than ``cap`` qualify. On the
    card three launches, the first ``level_areas``, counting into ``buf``
    (from ``scratch``; made here if None); ``tiers`` are the twin's run
    capacities and the kernel needs none."""
    global launches
    _check(lbl, amin, cap, root, area, over, buf)
    if lbl.device.type == "cpu":
        r, a, o = _level_candidates_ref(lbl, amin, cap, tiers)
        root.copy_(r)
        area.copy_(a)
        over.copy_(o.reshape(over.shape))
        return
    n = lbl.numel()
    lib = _kernel_lib()
    if buf is None:
        buf = scratch(n, lbl.device)
    if buf.numel() < lib.compv_level_areas_scratch(n):
        raise ValueError(f"scratch: {buf.numel()} entries, "
                         f"{lib.compv_level_areas_scratch(n)} needed")
    with torch.cuda.device(lbl.device):
        rc = lib.compv_level_areas(
            lbl.data_ptr(), n, amin, cap, buf.data_ptr(), root.data_ptr(),
            area.data_ptr(), over.data_ptr(),
            torch.cuda.current_stream(lbl.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compv_level_areas launch failed: cudaError {rc}")
    launches += 1
