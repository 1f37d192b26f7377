"""ORB: oriented FAST + rotated BRIEF-256 (mirror of
``compv_tpu/features/orb.py``).

Per level of an 8-level bilinear pyramid (sf 0.83): FAST-9 strengths and
3x3 NMS (the Hopper kernel K1 on CUDA), border erase at the patch radius,
top-k within the level's budget, intensity-centroid orientation from dense
moment maps, Gaussian blur (5 taps, sigma 2), rotated BRIEF-256 sampled
nearest-neighbour from the blurred level; then the global top
``max_features`` by strength. Coordinates are refined by a quadratic vertex
fit on the pre-NMS response and scaled back to level 0.

BRIEF is the reference's gather form (``orb.py:209-220``, the branch its
CPU tests run); its one-hot MXU form is a TPU device and is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.image.pyramid import (pyramid_sizes, scale_factors,
                                           scale_factors_sum)
from compv_tpu_torch.image.scale import scale as scale_image
from compv_tpu_torch.ops.bitops import pack_bits_to_bytes
from compv_tpu_torch.ops.conv import gaussian_blur
from compv_tpu_torch.ops.kernels import fast_kernel
from compv_tpu_torch.ops.topk import select_top_k, select_top_k_2d

__all__ = ["OrbConfig", "brief_pattern", "patch_orientation", "brief_describe",
           "orb_detect_describe", "OrbResult"]

PATCH_DIAMETER = 31   # COMPV_FEATURE_DETE_ORB_PATCH_DIAMETER (orb_dete.cxx:41)
PATCH_RADIUS = PATCH_DIAMETER // 2
DESC_BITS = 256       # COMPV_FEATURE_DETE_ORB_PATCH_BITS (orb_dete.cxx:42)

# f32 constants of jnp.rad2deg / jnp.deg2rad
_RAD2DEG = float(np.float32(180 / np.pi))
_DEG2RAD = float(np.float32(np.pi / 180))


@dataclass(frozen=True)
class OrbConfig:
    max_features: int = 2000      # COMPV_FEATURE_DETE_ORB_FAST_MAX_FEATURES
    threshold: int = 20
    fast_n: int = 9
    nms: bool = True
    levels: int = 8               # COMPV_FEATURE_DETE_ORB_PYRAMID_LEVELS
    scale_factor: float = 0.83    # COMPV_FEATURE_DETE_ORB_PYRAMID_SF
    blur_size: int = 5            # COMPV_FEATURE_DESC_ORB_GAUSS_KERN_SIZE
    blur_sigma: float = 2.0       # COMPV_FEATURE_DESC_ORB_GAUSS_KERN_SIGMA
    subpixel: bool = True         # quadratic-vertex keypoint refinement


def brief_pattern(bits: int = DESC_BITS, patch: int = PATCH_DIAMETER,
                  seed: int = 0xC0F
                  ) -> np.ndarray:
    """Deterministic BRIEF test-pair pattern, (bits, 4) int32 [ax, ay, bx, by].

    Original-BRIEF GII sampling: A,B ~ iid N(0, (patch/5)^2), rejection-
    sampled into the disc of radius patch/2 - 1.5 so rotated samples stay in
    the patch. Copy of the reference's generator; a test proves the two
    patterns equal."""
    rs = np.random.default_rng(seed)
    sigma = patch / 5.0
    rmax = patch / 2.0 - 1.5
    out = np.zeros((bits, 4), np.int32)
    for i in range(bits):
        pts = []
        while len(pts) < 2:
            p = rs.normal(0.0, sigma, 2)
            if p[0] ** 2 + p[1] ** 2 <= rmax ** 2:
                pts.append(np.round(p).astype(np.int32))
        out[i] = [pts[0][0], pts[0][1], pts[1][0], pts[1][1]]
    return out


_PATTERN = brief_pattern()  # (256, 4) i32 numpy
_pattern_by_device: dict[torch.device, torch.Tensor] = {}


def _pattern_on(device: torch.device) -> torch.Tensor:
    """The BRIEF pattern as an f32 (256, 4) tensor, copied once per device:
    a copy from pageable host memory on every call would make the host wait
    for the device's queue."""
    pat = _pattern_by_device.get(device)
    if pat is None:
        pat = torch.as_tensor(_PATTERN, dtype=torch.float32, device=device)
        _pattern_by_device[device] = pat
    return pat


def _m10_map(img: torch.Tensor) -> torch.Tensor:
    """Dense map of the disc first moment m10(y, x) = sum over the
    radius-15 disc of dx * I(y+dy, x+dx), by static shifts only.

    Row moments build incrementally over the half-width e,
    M_e = M_{e-1} + e * (I(., x+e) - I(., x-e)); the disc is 31 row-shifted
    copies picking M_{e(|dy|)}, e(dy) = floor(sqrt(r^2 - dy^2)). All values
    are integers below 2^24, so the f32 sums are exact in any order."""
    f = img.to(torch.float32)
    h, w = f.shape
    r = PATCH_RADIUS

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

    es = [int(np.floor(np.sqrt(r * r - dy * dy))) for dy in range(r + 1)]
    m_by_e = {0: torch.zeros_like(f)}
    m = torch.zeros_like(f)
    for e in range(1, r + 1):
        m = m + float(e) * (shx(f, e) - shx(f, -e))
        m_by_e[e] = m
    out = m_by_e[es[0]]
    for dy in range(1, r + 1):
        me = m_by_e[es[dy]]
        out = out + shy(me, dy) + shy(me, -dy)
    return out


def patch_orientation(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """IC-moment orientation in degrees [0,360) for keypoints at integer-
    rounded (x, y): atan2(m01, m10) over the radius-15 disc
    (orb_dete.cxx:336-344), gathered from dense moment maps."""
    h, w = img.shape
    m10_map = _m10_map(img)
    m01_map = _m10_map(img.T).T
    xi = x.round().to(torch.int64).clamp(PATCH_RADIUS, w - 1 - PATCH_RADIUS)
    yi = y.round().to(torch.int64).clamp(PATCH_RADIUS, h - 1 - PATCH_RADIUS)
    deg = torch.atan2(m01_map[yi, xi], m10_map[yi, xi]) * _RAD2DEG
    deg = torch.where(deg < 0, deg + 360.0, deg)
    return torch.where(valid, deg, 0.0)


def brief_describe(blurred: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   orientation_deg: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """Rotated BRIEF-256 on a pre-blurred image -> (K, 256) u8 bits: rotate
    each pattern point by the keypoint angle, round to the nearest int,
    sample nearest-neighbour, bit = (I[A] < I[B]) (orb_desc.cxx:477-518)."""
    h, w = blurred.shape
    f = blurred.to(torch.float32)
    th = orientation_deg * _DEG2RAD
    cos_t, sin_t = th.cos()[:, None], th.sin()[:, None]       # (K, 1)
    xi = x.round().to(torch.int64)[:, None]
    yi = y.round().to(torch.int64)[:, None]
    pat = _pattern_on(blurred.device)

    def sample(px, py):
        rx = (px[None, :] * cos_t - py[None, :] * sin_t).round().to(torch.int64)
        ry = (px[None, :] * sin_t + py[None, :] * cos_t).round().to(torch.int64)
        return f[(yi + ry).clamp(0, h - 1), (xi + rx).clamp(0, w - 1)]

    a = sample(pat[:, 0], pat[:, 1])
    b = sample(pat[:, 2], pat[:, 3])
    bits = (a < b).to(torch.uint8)
    return torch.where(valid[:, None], bits, 0)


class OrbResult(NamedTuple):
    keypoints: Keypoints          # level-0 coords, capacity = max_features
    descriptors: torch.Tensor     # (max_features, 256) u8 bits (unpacked)

    def packed(self) -> torch.Tensor:
        """(max_features, 32) u8 — the reference's 32-byte descriptor rows."""
        return pack_bits_to_bytes(self.descriptors)


def _level_budgets(cfg: OrbConfig):
    """Per-level feature budget: max_features * sf^lv / sfs, >= 10
    (orb_dete.cxx:301-311)."""
    sfs = scale_factors_sum(cfg.levels, cfg.scale_factor)
    return [max(int(round(cfg.max_features * sf / sfs)), 10)
            for sf in scale_factors(cfg.levels, cfg.scale_factor)]


def _subpixel_offsets(s: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Per-axis quadratic vertex offsets in [-0.5, 0.5] from the 4-neighbour
    response samples around integer keypoints (x, y). Valid keypoints are
    interior; the indices of padding entries are clamped into the map."""
    h, w = s.shape
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)

    def at(yy, xx):
        return s[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    sc = at(yi, xi)

    def vertex(a, b, c):
        # parabola through (-1,a),(0,b),(1,c): vertex at (a-c)/(2(a-2b+c))
        den = a - 2.0 * b + c
        off = torch.where(den.abs() > 1e-6, (a - c) / (2.0 * den), 0.0)
        return off.clamp(-0.5, 0.5)

    return (vertex(at(yi, xi - 1), sc, at(yi, xi + 1)),
            vertex(at(yi - 1, xi), sc, at(yi + 1, xi)))


def orb_detect_describe(img: torch.Tensor, config: OrbConfig = OrbConfig()
                        ) -> OrbResult:
    """Full ORB pipeline on a grayscale (H, W) u8 image. All output shapes
    follow from the image shape and the config, so nothing waits on the
    device."""
    img = img.contiguous()
    h, w = img.shape
    dev = img.device
    budgets = _level_budgets(config)
    sizes = pyramid_sizes(h, w, config.levels, config.scale_factor)
    sfs = scale_factors(config.levels, config.scale_factor)

    parts = []
    for lv in range(config.levels):
        lh, lw = sizes[lv]
        if lh < PATCH_DIAMETER + 2 or lw < PATCH_DIAMETER + 2:
            continue  # no keypoint can have a fully interior patch
        k = min(budgets[lv], lh * lw)
        level_img = img if lv == 0 else scale_image(img, lh, lw, "bilinear")

        if config.nms:
            s_raw, s = fast_kernel.fast_strengths_and_nms(
                level_img, config.threshold, config.fast_n)
        else:
            s = fast_kernel.fast_strengths_nms(
                level_img, config.threshold, config.fast_n, nms=False,
                as_f32=True)
            s_raw = s
        # border erase at the patch radius (orb_dete.cxx:318-323)
        s = torch.where(fast_kernel._interior(lh, lw, PATCH_RADIUS, dev), s, 0.0)

        vals, idx = select_top_k_2d(s, k)
        valid = vals > 0
        lx = (idx % lw).to(torch.float32)
        ly = (idx // lw).to(torch.float32)

        orient = patch_orientation(level_img, lx, ly, valid)
        blurred = gaussian_blur(level_img, config.blur_size, config.blur_sigma)
        desc = brief_describe(blurred, lx, ly, orient, valid)

        if config.subpixel:
            rx, ry = _subpixel_offsets(s_raw, lx, ly)
            lxo = lx + torch.where(valid, rx, 0.0)
            lyo = ly + torch.where(valid, ry, 0.0)
        else:
            lxo, lyo = lx, ly

        inv_sf = 1.0 / sfs[lv]
        inv_sf32 = float(np.float32(inv_sf))  # the reference scales in f32
        parts.append((
            Keypoints(
                x=torch.where(valid, lxo * inv_sf32, 0.0),
                y=torch.where(valid, lyo * inv_sf32, 0.0),
                strength=torch.where(valid, vals, 0.0),
                orientation=orient,
                level=torch.full((k,), lv, dtype=torch.int32, device=dev),
                size=torch.full((k,), PATCH_DIAMETER * inv_sf,
                                dtype=torch.float32, device=dev),
                valid=valid,
            ),
            desc,
        ))

    if not parts:
        k = config.max_features
        zf = torch.zeros((k,), dtype=torch.float32, device=dev)
        return OrbResult(
            keypoints=Keypoints(zf, zf, zf, zf,
                                torch.zeros((k,), dtype=torch.int32, device=dev),
                                zf, torch.zeros((k,), dtype=torch.bool,
                                                device=dev)),
            descriptors=torch.zeros((k, DESC_BITS), dtype=torch.uint8,
                                    device=dev))

    kp_all = Keypoints(*[torch.cat([getattr(p[0], fld) for p in parts])
                         for fld in Keypoints._fields])
    desc_all = torch.cat([p[1] for p in parts], dim=0)

    # global top max_features by strength
    kcap = min(config.max_features, kp_all.capacity)
    svals = torch.where(kp_all.valid, kp_all.strength, -torch.inf)
    _, sel = select_top_k(svals, kcap)
    return OrbResult(keypoints=kp_all._take(sel),
                     descriptors=desc_all.index_select(0, sel))
