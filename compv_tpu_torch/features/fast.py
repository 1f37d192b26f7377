"""FAST-9/12 corner detector (mirror of ``compv_tpu/features/fast.py``).

Per pixel p with threshold t, corner iff some arc of N consecutive circle
pixels (r=3, 16 points, mod 16) is all brighter than p + t or all darker
than p - t; strength = the max over such arcs of the min diff
(fast_dete.cxx:688-767). Strict 3x3 NMS, then top-K by strength.

The strength map (and its NMS) comes from the hand-written Hopper kernel
K1 (``ops/kernels/fast_kernel.py``) on CUDA tensors, and from its plain
twin on CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.ops.kernels import fast_kernel
from compv_tpu_torch.ops.kernels.fast_kernel import CIRCLE_OFFSETS
from compv_tpu_torch.ops.topk import top_k_2d

__all__ = ["FastConfig", "fast_strengths", "fast_nms", "fast_detect",
           "CIRCLE_OFFSETS"]


@dataclass(frozen=True)
class FastConfig:
    """Defaults per fast_dete.cxx:76-81."""
    threshold: int = 20
    n: int = 9                 # FAST-9 or FAST-12 (arc length)
    nms: bool = True
    max_features: int = 2000   # static output capacity
    exact_topk: bool = False   # kept for parity; the port's top-k is exact


def fast_strengths(img: torch.Tensor, threshold: int = 20, n: int = 9
                   ) -> torch.Tensor:
    """Dense strengths map (H, W) u8 (reference FastDataRow semantics)."""
    return fast_kernel.fast_strengths_nms(img, threshold, n, nms=False)


def fast_nms(strengths: torch.Tensor) -> torch.Tensor:
    """3x3 non-maxima suppression of a given strengths map: suppress the
    center if ANY 8-neighbor has strength >= center (CompVFastNmsGather_C,
    fast_dete.cxx:773-816), applied in [3, dim-3). Plain tensor code on
    every device; the detector itself fuses NMS into K1."""
    return fast_kernel._nms_ref(strengths.to(torch.float32)).to(torch.uint8)


def fast_detect(img: torch.Tensor, config: FastConfig = FastConfig()
                ) -> Keypoints:
    """Strengths -> optional NMS -> top-K Keypoints of capacity
    ``max_features``, sorted by decreasing strength
    (CompVCornerDeteFAST::process, fast_dete.cxx:162-330)."""
    h, w = img.shape
    s = fast_kernel.fast_strengths_nms(img.contiguous(), config.threshold,
                                       config.n, nms=config.nms, as_f32=True)
    k = min(config.max_features, h * w)
    vals, idx = top_k_2d(s, k)
    valid = vals > 0
    x = (idx % w).to(torch.float32)
    y = (idx // w).to(torch.float32)
    return Keypoints(
        x=torch.where(valid, x, 0.0),
        y=torch.where(valid, y, 0.0),
        strength=torch.where(valid, vals, 0.0),
        orientation=torch.zeros_like(vals),
        level=torch.zeros_like(idx, dtype=torch.int32),
        size=torch.full_like(vals, 7.0),
        valid=valid,
    )
