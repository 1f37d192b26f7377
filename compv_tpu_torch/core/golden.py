"""Golden-value helpers: copies of ``compv_tpu/core/golden.py``
``ccl_summary``, ``lines_summary`` and ``mser_summary``, which that module
cannot lend (it imports ``jax.numpy``). They read numpy arrays, and tensors
on any device; ``tests/test_torch_ccl.py`` and ``tests/test_torch_hough.py``
prove each copy equal to its original.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ccl_summary", "lines_summary", "mser_summary"]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ccl_summary(res) -> dict:
    """Component-features golden tuple. Capacity must cover every
    component (num_components <= valid.sum()) so the summary is
    tie-break-free."""
    v = _np(res.valid)
    return {
        "num": int(_np(res.num_components)),
        "sum_area": int(_np(res.area)[v].sum()),
        "sum_boxes": int((_np(res.box_x0)[v] + _np(res.box_y0)[v]
                          + _np(res.box_x1)[v] + _np(res.box_y1)[v]).sum()),
        "sum_cx": round(float(_np(res.cx)[v].sum()), 2),
        "sum_cy": round(float(_np(res.cy)[v].sum()), 2),
    }


def lines_summary(lines) -> dict:
    """Hough golden tuple over the valid fixed-capacity peaks."""
    v = _np(lines.valid)
    return {
        "count": int(v.sum()),
        "sum_rho": round(float(_np(lines.rho)[v].sum()), 2),
        "sum_theta": round(float(_np(lines.theta)[v].sum()), 4),
        "sum_strength": round(float(_np(lines.strength)[v].sum()), 2),
    }


def mser_summary(res) -> dict:
    """MSER golden tuple over the valid regions (+ the overflow flag,
    which must be zero for a trustworthy golden)."""
    v = _np(res.valid)
    return {
        "count": int(v.sum()),
        "sum_area": int(_np(res.area)[v].sum()),
        "sum_level": int(_np(res.level)[v].sum()),
        "sum_seed_x": int(_np(res.seed_x)[v].sum()),
        "sum_seed_y": int(_np(res.seed_y)[v].sum()),
        "overflowed": int(_np(res.overflowed)),
    }
