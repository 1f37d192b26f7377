"""Canny edge detector (mirror of ``compv_tpu/features/canny.py``).

Sobel gradients, L1 magnitude, fixed or percent-of-mean thresholds,
4-sector non-maximum suppression with the reference's f32 ``tan 22.5``
constant and neighbour choice, then hysteresis as iterated 3x3 dilation of
the strong map inside the weak map. The hysteresis is the reference's loop
as written (``canny.py:95-110``): 4 dilations per ``changed`` check and at
most ``max_hysteresis_iters`` checks, so a chain longer than that is cut
where the reference cuts it. Each check is a host sync here (the
reference's ``lax.while_loop`` keeps it on the device); the module-level
``last_syncs`` holds the count of the last call.

``threshold_type="mean"`` takes ``torch.mean``, whose summation order is
not XLA's: the threshold may differ by an ulp, and then pixels sitting on
it may flip.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from compv_tpu_torch.features.edges import sobel_gradients

__all__ = ["CannyConfig", "canny"]

# host syncs (hysteresis ``changed`` checks) of the last canny call
last_syncs = 0

_TAN_22_5 = np.float32(0.41421356)


@dataclass(frozen=True)
class CannyConfig:
    """Defaults per the reference's canny bench; threshold_type 'fixed' |
    'mean' (percent of the mean magnitude)."""
    threshold_low: float = 59.0
    threshold_high: float = 119.0
    threshold_type: str = "fixed"
    max_hysteresis_iters: int = 64


def _shifted(p: torch.Tensor, dy: int, dx: int, h: int, w: int):
    """Window of the 1-px padded map ``p`` at offset (dy, dx)."""
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _nms_gradient(mag, gx, gy):
    """Suppress non-maxima along the quantized gradient direction
    (4 sectors: 0, 45, 90, 135 deg)."""
    h, w = mag.shape
    p = torch.nn.functional.pad(mag, (1, 1, 1, 1))
    ax = gx.abs()
    ay = gy.abs()
    t = torch.tensor(_TAN_22_5, device=mag.device)
    horiz = ay <= t * ax
    vert = ax <= t * ay
    same_sign = (gx * gy) >= 0   # gradient along +45deg (image coords)

    def sl(dy, dx):
        return _shifted(p, dy, dx, h, w)

    n1 = torch.where(horiz, sl(0, -1),
                     torch.where(vert, sl(-1, 0),
                                 torch.where(same_sign, sl(-1, -1),
                                             sl(-1, 1))))
    n2 = torch.where(horiz, sl(0, 1),
                     torch.where(vert, sl(1, 0),
                                 torch.where(same_sign, sl(1, 1), sl(1, -1))))
    keep = (mag >= n1) & (mag > n2)
    return torch.where(keep, mag, torch.zeros_like(mag))


def _dilate3_bool(x: torch.Tensor) -> torch.Tensor:
    """3x3 dilation with a zero border, as a row pass then a column pass
    (OR is associative, so this equals the reference's 9-window OR)."""
    r = x.clone()
    r[:, 1:] |= x[:, :-1]
    r[:, :-1] |= x[:, 1:]
    out = r.clone()
    out[1:] |= r[:-1]
    out[:-1] |= r[1:]
    return out


def canny(img: torch.Tensor, config: CannyConfig = CannyConfig()
          ) -> torch.Tensor:
    """(H, W) u8 -> (H, W) u8 binary edge map {0, 255}."""
    global last_syncs
    gx, gy = sobel_gradients(img, "sobel")
    mag = gx.abs() + gy.abs()
    dev = img.device
    if config.threshold_type == "mean":
        mean = mag.mean()
        tlow = mean * torch.tensor(np.float32(config.threshold_low / 100.0),
                                   device=dev)
        thigh = mean * torch.tensor(np.float32(config.threshold_high / 100.0),
                                    device=dev)
    else:
        tlow = torch.tensor(np.float32(config.threshold_low), device=dev)
        thigh = torch.tensor(np.float32(config.threshold_high), device=dev)

    nms = _nms_gradient(mag, gx, gy)
    strong = nms >= thigh
    weak = nms >= tlow

    syncs = 0
    changed = True
    while changed and syncs < config.max_hysteresis_iters:
        # propagate several steps per convergence check
        grown = strong
        for _ in range(4):
            grown = _dilate3_bool(grown) & weak
        changed = bool((grown != strong).any())
        strong = grown
        syncs += 1
    last_syncs = syncs

    # zero the 1-px border like the reference's edge maps
    h, w = img.shape
    out = torch.where(strong, 255, 0).to(torch.uint8)
    out[0, :] = 0
    out[h - 1, :] = 0
    out[:, 0] = 0
    out[:, w - 1] = 0
    return out
