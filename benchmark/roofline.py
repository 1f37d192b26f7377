"""Roofline arithmetic of the benchmark: published peaks, the least time a
call could take, and the work models of the modelled stages.

``PEAKS``, ``bound`` and ``fast9_model`` are copies of
``scripts/roofline_torch.py`` (NVIDIA's data sheet: 3.35 TB/s HBM, 67
TFLOP/s fp32 and a quarter of that in int32 operations; dense bf16 and
int8 tensor rates), kept here so the yardstick does not move with the
program. ``early_out_candidates`` and ``pairs`` are copies of
``ops/kernels/fast_kernel.py``'s opposite-pair test and of
``scripts/roofline_torch.py``'s pixel-pair count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "f32": 67e12,
                              "int32": 67e12 / 4, "bf16": 989e12,
                              "int8": 1979e12},
}

CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast9_model(h: int, w: int, pairs_brighter: int, pairs_darker: int,
                k: int = 2000):
    n = h * w
    return (n + k * (4 + 8),
            {"int32": 18 * n + 40 * (pairs_brighter + pairs_darker) + n},
            "u8 image in, top-k (f32 value, i64 index) out; per pixel 18 "
            "(opposite-pair tests, combination, NMS as 16-bit pairs), 40 a "
            "pixel pair and side that passes its test (arc minima), 1 "
            "compare for the top-k")


def bound(nbytes: float, ops: dict, peaks: dict) -> dict:
    """The least time the card could take: the bytes at the memory rate,
    or each unit's operations at its peak, summed, whichever is larger."""
    by_bytes = nbytes / peaks["hbm"] * 1e3
    by_ops = sum(n / peaks[unit] for unit, n in ops.items()) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def early_out_candidates(img: torch.Tensor, threshold: int):
    """(H, W) bool maps of the interior pixels that pass the brighter and
    the darker opposite-pair test of FAST-9."""
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
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return (a > f + threshold) & inside, (b + threshold < f) & inside


def pairs(cand: torch.Tensor) -> int:
    """Horizontal pixel pairs of which a pixel is a candidate."""
    cand = F.pad(cand, (0, cand.shape[1] % 2))
    return int((cand[:, 0::2] | cand[:, 1::2]).sum())


def fast_stage(args) -> tuple:
    """Work of one FAST stage call, ``fast_strengths_and_nms(level,
    threshold, n)``: bytes once (the u8 level in, the raw and the NMS f32
    maps out) and ``fast9_model``'s operations without its top-k compare,
    which is not this stage's work. Returns (bytes, ops)."""
    img = args[0]
    threshold = int(args[1]) if len(args) > 1 else 20
    h, w = img.shape
    pb, pd = (pairs(c) for c in early_out_candidates(img, threshold))
    _, ops, _ = fast9_model(h, w, pb, pd)
    n = h * w
    return n + 2 * 4 * n, {"int32": ops["int32"] - n}


MODELS = {"fast9_stage": fast_stage}


def stage_bound_ms(model: str, calls: list, peaks: dict) -> float:
    """The summed least time of a stage's calls."""
    total = 0.0
    for args in calls:
        nbytes, ops = MODELS[model](args)
        total += bound(nbytes, ops, peaks)["bound_ms"]
    return total
