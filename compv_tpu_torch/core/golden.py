"""Golden-value helpers: copies of ``compv_tpu/core/golden.py``, which
that module cannot lend (it imports ``jax.numpy``). They read numpy
arrays, and tensors on any device; ``tests/test_torch_ccl.py``,
``tests/test_torch_hough.py``, ``tests/test_torch_ba.py`` and
``tests/test_torch_fit.py`` prove each copy equal to its original.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["keypoint_summary", "exact_hash", "quantized_hash",
           "assert_allclose", "ccl_summary", "lines_summary", "mser_summary"]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def keypoint_summary(kp) -> dict:
    """count / sum of strength / sum of x / sum of y over the valid
    keypoints: the reference's FAST golden tuple
    (unittests/feature_fast.cxx:31-41)."""
    v = _np(kp.valid)
    return {
        "count": int(v.sum()),
        "sum_strength": float(_np(kp.strength)[v].sum()),
        "sum_x": float(_np(kp.x)[v].sum()),
        "sum_y": float(_np(kp.y)[v].sum()),
    }


def exact_hash(arr) -> str:
    """MD5 of the raw bytes of an integer array (reference compv_tests_md5,
    rows without stride)."""
    a = np.ascontiguousarray(_np(arr))
    return hashlib.md5(a.tobytes()).hexdigest()


def assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


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


def quantized_hash(arr, decimals: int = 3) -> str:
    """Tolerance-hash for float outputs: round to ``decimals``, then MD5.
    Stable across backends as long as values agree to 10^-decimals."""
    a = np.asarray(_np(arr), dtype=np.float64)
    q = np.round(a, decimals) + 0.0  # +0.0 normalizes -0.0
    return hashlib.md5(q.tobytes()).hexdigest()
