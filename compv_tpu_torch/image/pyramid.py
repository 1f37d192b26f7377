"""Image scale pyramid (mirror of ``compv_tpu/image/pyramid.py``;
reference CompVImageScalePyramid, compv_image_scale_pyramid.cxx:62,163).
The size helpers are copies of the reference's pure-Python ones (a test
proves each copy equal to the original); each level's size is
round(dim * sf^lv), and each level is scaled from level 0, not cascaded.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.image.scale import scale

__all__ = ["Pyramid", "pyramid_sizes", "build_pyramid", "scale_factors",
           "scale_factors_sum"]


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


@dataclass
class Pyramid:
    """The per-level images and their metadata."""
    levels: int
    scale_factor: float
    images: List[torch.Tensor] = field(default_factory=list)

    @property
    def factors(self) -> List[float]:
        return scale_factors(self.levels, self.scale_factor)

    @property
    def factors_sum(self) -> float:
        return scale_factors_sum(self.levels, self.scale_factor)

    def image_at(self, level: int) -> torch.Tensor:
        return self.images[level]


@at_x64_off
def build_pyramid(img: torch.Tensor, levels: int = 8,
                  scale_factor: float = 0.83,
                  interpolation: str = "bilinear") -> Pyramid:
    """All levels from the level-0 image (ORB's defaults: 8 levels, 0.83,
    bilinear; orb_dete.cxx:39-44)."""
    h, w = img.shape[:2]
    images = [img]
    for lh, lw in pyramid_sizes(h, w, levels, scale_factor)[1:]:
        images.append(scale(img, lh, lw, interpolation))
    return Pyramid(levels=levels, scale_factor=scale_factor, images=images)
