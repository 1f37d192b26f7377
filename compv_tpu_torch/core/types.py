"""Core result containers: fixed-capacity, masked NamedTuples of tensors.

Mirror of ``compv_tpu/core/types.py``: the same fields, capacities and
``valid`` masks, so the two packages compare field by field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from compv_tpu_torch.ops.topk import select_top_k

__all__ = ["Keypoints", "Matches"]


class Keypoints(NamedTuple):
    """Fixed-capacity set of interest points; entries with ``valid == False``
    are padding (reference CompVInterestPoint as a struct of arrays)."""

    x: torch.Tensor            # (K,) f32 — level-0 pixel coords
    y: torch.Tensor            # (K,) f32
    strength: torch.Tensor     # (K,) f32 — detector response
    orientation: torch.Tensor  # (K,) f32 — degrees [0, 360)
    level: torch.Tensor        # (K,) i32 — pyramid level
    size: torch.Tensor         # (K,) f32 — patch diameter at level 0
    valid: torch.Tensor        # (K,) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

    @staticmethod
    def empty(capacity: int, device=None) -> "Keypoints":
        z = torch.zeros((capacity,), dtype=torch.float32, device=device)
        return Keypoints(
            x=z, y=z, strength=z, orientation=z,
            level=torch.zeros((capacity,), dtype=torch.int32, device=device),
            size=torch.full((capacity,), 7.0, dtype=torch.float32,
                            device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def _take(self, idx: torch.Tensor) -> "Keypoints":
        """Gather every field at ``idx`` along the keypoint axis."""
        return Keypoints(*[f.index_select(-1, idx) for f in self])

    def select_best(self, k: int) -> "Keypoints":
        """The ``k`` strongest points, sorted by decreasing strength (ties:
        lower index first, as ``lax.top_k``)."""
        s = torch.where(self.valid, self.strength,
                        torch.full_like(self.strength, -torch.inf))
        _, idx = select_top_k(s, k)
        return self._take(idx)

    def erase_near_border(self, width: int, height: int,
                          border_x: float, border_y: float) -> "Keypoints":
        """Invalidate points whose patch crosses the image border."""
        ok = ((self.x >= border_x) & (self.y >= border_y)
              & (self.x < width - border_x) & (self.y < height - border_y))
        return self._replace(valid=self.valid & ok)


class Matches(NamedTuple):
    """KNN match result in the dense (K, Nq) layout of the reference
    matcher's output Mat."""

    train_idx: torch.Tensor  # (K, Nq) i32
    distance: torch.Tensor   # (K, Nq) f32 (Hamming distance is integral)
    valid: torch.Tensor      # (K, Nq) bool
