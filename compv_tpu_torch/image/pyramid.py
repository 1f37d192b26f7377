"""Scale-pyramid sizes and factors (copies of the pure-Python helpers of
``compv_tpu/image/pyramid.py``; a test proves each copy equal to the
original). The reference computes each level's size as round(dim * sf^lv)
(compv_image_scale_pyramid.cxx:163)."""
from __future__ import annotations

from typing import List

__all__ = ["pyramid_sizes", "scale_factors", "scale_factors_sum"]


def scale_factors(levels: int, scale_factor: float) -> List[float]:
    return [scale_factor ** i for i in range(levels)]


def scale_factors_sum(levels: int, scale_factor: float) -> float:
    return float(sum(scale_factors(levels, scale_factor)))


def pyramid_sizes(h: int, w: int, levels: int, scale_factor: float):
    """Per-level (h, w)."""
    out = []
    for lv in range(levels):
        sf = scale_factor ** lv
        out.append((max(int(round(h * sf)), 1), max(int(round(w * sf)), 1)))
    return out
