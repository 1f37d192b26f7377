"""ORB keypoint orientation: the Hopper kernel ``orb_orient``
(``csrc/orient_kernel.cu``), which replaces no TPU kernel, and its plain
PyTorch twin.

The twin, ``_m10_map`` + ``_orientation_ref``, is the JAX detector's
(``compv_tpu/features/orb.py:158-167``): dense maps of the radius-15 disc
moments m10 and m01 over the whole level image by static shifts, gathered
at the keypoints. Under one ``jit`` those ~90 passes fuse; run eagerly on
the card each is a launch, ~380 an image and level. The kernel computes
the two moments at the keypoints only, in one launch, and reproduces the
twin bit for bit for u8 and f32 images: the same rounding and clamping of
the keypoint, the same order of every sum (the row moments built outward,
then folded centre, +d, -d), pixels outside the image read as 0, and
``atan2f`` of the card's math library, as PyTorch's CUDA ``atan2``.

Dispatch has no fallback: CUDA tensors go to the kernel (built at first
use) or the call raises; CPU tensors go to the twin. Its launches are
counted under ``orb_orient`` (``_build.launch_counts``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from compv_tpu_torch.ops.kernels import _build

__all__ = ["RADIUS", "HALF_WIDTHS", "patch_orientation"]

RADIUS = 15
# E(d) = floor(sqrt(r^2 - d^2)): the disc's half-width at row offset d
HALF_WIDTHS = tuple(int(np.floor(np.sqrt(RADIUS * RADIUS - d * d)))
                    for d in range(RADIUS + 1))
# the f32 constant of jnp.rad2deg
_RAD2DEG = float(np.float32(180 / np.pi))

_p, _i = ctypes.c_void_p, ctypes.c_int
_orient = _build.Library("orient_kernel").entry(
    "compv_orb_orient", [_p, _i, _i, _i, _p, _p, _p, _p, _i, _p],
    counts="orb_orient")


def _m10_map(img: torch.Tensor) -> torch.Tensor:
    """Dense map of the disc first moment m10(y, x) = sum over the
    radius-15 disc of dx * I(y+dy, x+dx), by static shifts only.

    Row moments build incrementally over the half-width e,
    M_e = M_{e-1} + e * (I(., x+e) - I(., x-e)); the disc is 31 row-shifted
    copies picking M_{e(|dy|)}, e(dy) = floor(sqrt(r^2 - dy^2)). For a u8
    image all values are integers below 2^24, so the f32 sums are exact in
    any order; for an f32 image this order is the one the kernel keeps."""
    f = img.to(torch.float32)
    h, w = f.shape
    r = RADIUS

    def shx(a, d):
        if d > 0:
            return F.pad(a, (0, d))[:, d:]
        return F.pad(a, (-d, 0))[:, :w]

    def shy(a, d):
        if d == 0:
            return a
        if d > 0:
            return F.pad(a, (0, 0, 0, d))[d:, :]
        return F.pad(a, (0, 0, -d, 0))[:h, :]

    m_by_e = {0: torch.zeros_like(f)}
    m = torch.zeros_like(f)
    for e in range(1, r + 1):
        m = m + float(e) * (shx(f, e) - shx(f, -e))
        m_by_e[e] = m
    out = m_by_e[HALF_WIDTHS[0]]
    for dy in range(1, r + 1):
        me = m_by_e[HALF_WIDTHS[dy]]
        out = out + shy(me, dy) + shy(me, -dy)
    return out


def _orientation_ref(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The twin: atan2(m01, m10) in degrees [0, 360) gathered from the
    dense moment maps at the integer-rounded, clamped keypoints."""
    h, w = img.shape
    m10_map = _m10_map(img)
    m01_map = _m10_map(img.T).T
    xi = x.round().to(torch.int64).clamp(RADIUS, w - 1 - RADIUS)
    yi = y.round().to(torch.int64).clamp(RADIUS, h - 1 - RADIUS)
    deg = torch.atan2(m01_map[yi, xi], m10_map[yi, xi]) * _RAD2DEG
    deg = torch.where(deg < 0, deg + 360.0, deg)
    return torch.where(valid, deg, 0.0)


def _check(img, x, y, valid) -> None:
    for name, t in (("img", img), ("x", x), ("y", y), ("valid", valid)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if img.ndim != 2 or img.is_complex():
        raise ValueError(f"expected a 2-D real image, got {img.ndim}-D "
                         f"{img.dtype}")
    for name, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.ndim != 1 or t.dtype != dtype:
            raise ValueError(f"{name}: expected a 1-D {dtype} tensor, got "
                             f"{t.ndim}-D {t.dtype}")
    if not x.shape == y.shape == valid.shape:
        raise ValueError(f"x, y and valid differ in length: {tuple(x.shape)}"
                         f", {tuple(y.shape)}, {tuple(valid.shape)}")
    if not img.device == x.device == y.device == valid.device:
        raise ValueError("img, x, y and valid must be on one device")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


def _check_gather(h: int, w: int) -> None:
    """Raise the IndexError that the twin's gather raises on an (h, w)
    image with keypoints: on an axis under 31 px every keypoint clamps to
    n - 16, which torch indexing counts from the end down to n = 8."""
    for dim, n in ((0, h), (1, w)):
        if n - 1 - RADIUS < -n:
            raise IndexError(f"index {n - 1 - RADIUS} is out of bounds for "
                             f"dimension {dim} with size {n}")


def patch_orientation(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """(H, W) image, (K,) f32 x and y, (K,) bool valid -> (K,) f32
    intensity-centroid angles in degrees [0, 360), 0 where not valid. An
    image of a dtype other than u8 and f32 is taken as f32 (the twin's own
    first step). On the card one launch of ``orb_orient``."""
    _check(img, x, y, valid)
    if img.device.type == "cpu":
        return _orientation_ref(img, x, y, valid)
    if img.dtype not in (torch.uint8, torch.float32):
        img = img.to(torch.float32)
    h, w = img.shape
    k = x.shape[0]
    out = torch.empty((k,), dtype=torch.float32, device=img.device)
    if k == 0:
        return out
    _check_gather(h, w)
    _orient.launch(img.device, img.data_ptr(), int(img.dtype == torch.float32),
                   h, w, x.data_ptr(), y.data_ptr(), valid.data_ptr(),
                   out.data_ptr(), k)
    return out
