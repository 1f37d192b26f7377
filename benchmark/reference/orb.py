"""Plain PyTorch ORB: oriented FAST-9 + rotated BRIEF-256 over a bilinear
pyramid, the comparison side of the benchmark's ORB check.

A frozen copy of the arithmetic of the port's plain twins, written out
without any of the port's modules: ``features/orb.py`` (level loop,
moments, BRIEF, sub-pixel fit, global top-k), ``ops/kernels/fast_kernel.py``
(``_strengths_ref``, ``_nms_ref``: K1's twin), ``image/scale.py``
(``scale_bilinear``), ``ops/conv.py`` (``gaussian_blur``), ``ops/topk.py``
(stable top-k) and ``image/pyramid.py`` (level sizes). It imports nothing
of the port, so the yardstick does not move when the program does.

``dtype`` is the arithmetic of the pyramid, blur, moments, orientation,
BRIEF rotation and sub-pixel fit: float32 as the configuration states, or
bfloat16 for the control (FAST's integer strengths are exact in both).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PATCH_DIAMETER = 31
PATCH_RADIUS = PATCH_DIAMETER // 2
_RAD2DEG = float(np.float32(180 / np.pi))
_DEG2RAD = float(np.float32(np.pi / 180))

CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

FIELDS = ("x", "y", "strength", "orientation", "level", "valid")


def brief_pattern(bits: int = 256, patch: int = PATCH_DIAMETER,
                  seed: int = 0xC0F) -> np.ndarray:
    """BRIEF test pairs (bits, 4) [ax, ay, bx, by]: GII sampling in the disc
    of radius patch / 2 - 1.5, from ``default_rng(0xC0F)``."""
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


_PATTERN = brief_pattern()


def pyramid_sizes(h: int, w: int, levels: int, sf: float):
    return [(max(int(round(h * sf ** lv)), 1), max(int(round(w * sf ** lv)), 1))
            for lv in range(levels)]


def level_budgets(max_features: int, levels: int, sf: float):
    facs = [sf ** i for i in range(levels)]
    total = float(sum(facs))
    return [max(int(round(max_features * f / total)), 10) for f in facs]


def _top_k(x: torch.Tensor, k: int):
    """Descending, the lower index first among equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _interior(h, w, border, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)


def fast_strengths(img: torch.Tensor, threshold: int, n: int) -> torch.Tensor:
    """Dense FAST-n strengths (H, W) f32, 0 within 3 px of the border."""
    h, w = img.shape
    f = img.to(torch.float32)
    padded = F.pad(f, (3, 3, 3, 3))
    brighter = f + float(threshold)
    darker = f - float(threshold)
    d_list, b_list = [], []
    for dy, dx in CIRCLE_OFFSETS:
        c = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        d_list.append(darker - c)
        b_list.append(c - brighter)

    def arc(vals):
        m = list(vals)
        span = 1
        while span < n:
            step = min(span, n - span)
            m = [torch.minimum(m[k], m[(k + step) % 16]) for k in range(16)]
            span += step
        out = m[0]
        for k in range(1, 16):
            out = torch.maximum(out, m[k])
        return out

    s = torch.maximum(arc(d_list), arc(b_list)).clamp_min(0.0)
    return torch.where(_interior(h, w, 3, img.device), s, 0.0)


def nms3x3(s: torch.Tensor) -> torch.Tensor:
    """Strict 3x3 non-maximum suppression, applied in [3, dim - 3)."""
    h, w = s.shape
    padded = F.pad(s, (1, 1, 1, 1))
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                v = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                nmax = v if nmax is None else torch.maximum(nmax, v)
    keep = (s > 0) & (nmax < s)
    return torch.where(keep & _interior(h, w, 3, s.device), s, 0.0)


def scale_bilinear(img: torch.Tensor, oh: int, ow: int, dt) -> torch.Tensor:
    """u8 (H, W) -> u8 (oh, ow), half-pixel centres, ratio rounded to f32."""
    h, w = img.shape
    dev = img.device

    def coords(dn, sn):
        s = float(np.float32(sn / dn))
        return ((torch.arange(dn, dtype=torch.float32, device=dev) + 0.5) * s
                - 0.5)

    yf = coords(oh, h).clamp(0.0, h - 1.0)
    xf = coords(ow, w).clamp(0.0, w - 1.0)
    y0 = yf.floor().to(torch.int64)
    x0 = xf.floor().to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    wy = (yf - y0).to(dt)[:, None]
    wx = (xf - x0).to(dt)[None, :]
    f = img.to(dt)
    r0 = f.index_select(0, y0)
    r1 = f.index_select(0, y1)
    top = r0.index_select(1, x0) * (1 - wx) + r0.index_select(1, x1) * wx
    bot = r1.index_select(1, x0) * (1 - wx) + r1.index_select(1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.round().clamp(0, 255).to(torch.uint8)


def _gauss_taps(size: int, sigma: float) -> list:
    x = np.arange(-(size // 2), size // 2 + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32).tolist()


def gaussian_blur_u8(img: torch.Tensor, size: int, sigma: float, dt):
    """Separable zero-border blur, horizontal then vertical, u8 out."""
    taps = _gauss_taps(size, sigma)
    half = size // 2
    h, w = img.shape
    f = img.to(dt)
    p = F.pad(f, (half, half))
    out = None
    for i, k in enumerate(taps):
        t = p[:, i:i + w] * k
        out = t if out is None else out + t
    p = F.pad(out, (0, 0, half, half))
    out = None
    for i, k in enumerate(taps):
        t = p[i:i + h, :] * k
        out = t if out is None else out + t
    return out.round().clamp(0, 255).to(torch.uint8)


def _m10(img: torch.Tensor, dt) -> torch.Tensor:
    """sum over the radius-15 disc of dx * I(y + dy, x + dx), dense."""
    f = img.to(dt)
    h, w = f.shape
    r = PATCH_RADIUS

    def shx(a, d):
        return F.pad(a, (0, d))[:, d:] if d > 0 else F.pad(a, (-d, 0))[:, :w]

    def shy(a, d):
        if d == 0:
            return a
        return (F.pad(a, (0, 0, 0, d))[d:, :] if d > 0
                else F.pad(a, (0, 0, -d, 0))[:h, :])

    es = [int(np.floor(np.sqrt(r * r - dy * dy))) for dy in range(r + 1)]
    m_by_e = {0: torch.zeros_like(f)}
    m = torch.zeros_like(f)
    for e in range(1, r + 1):
        m = m + float(e) * (shx(f, e) - shx(f, -e))
        m_by_e[e] = m
    out = m_by_e[es[0]]
    for dy in range(1, r + 1):
        out = out + shy(m_by_e[es[dy]], dy) + shy(m_by_e[es[dy]], -dy)
    return out


def _orientation(img, x, y, valid, dt):
    h, w = img.shape
    m10 = _m10(img, dt)
    m01 = _m10(img.T, dt).T
    xi = x.round().to(torch.int64).clamp(PATCH_RADIUS, w - 1 - PATCH_RADIUS)
    yi = y.round().to(torch.int64).clamp(PATCH_RADIUS, h - 1 - PATCH_RADIUS)
    deg = torch.atan2(m01[yi, xi], m10[yi, xi]) * _RAD2DEG
    deg = torch.where(deg < 0, deg + 360.0, deg)
    return torch.where(valid, deg, torch.zeros_like(deg))


def _brief(blurred, x, y, deg, valid, dt):
    h, w = blurred.shape
    f = blurred.to(torch.float32)
    th = deg.to(dt) * _DEG2RAD
    cos_t, sin_t = th.cos()[:, None], th.sin()[:, None]
    xi = x.round().to(torch.int64)[:, None]
    yi = y.round().to(torch.int64)[:, None]
    pat = torch.as_tensor(_PATTERN, dtype=dt, device=blurred.device)

    def sample(px, py):
        rx = (px[None, :] * cos_t - py[None, :] * sin_t).round().to(torch.int64)
        ry = (px[None, :] * sin_t + py[None, :] * cos_t).round().to(torch.int64)
        return f[(yi + ry).clamp(0, h - 1), (xi + rx).clamp(0, w - 1)]

    bits = (sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3]))
    return torch.where(valid[:, None], bits.to(torch.uint8), 0)


def _subpixel(s, x, y, dt):
    h, w = s.shape
    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    s = s.to(dt)

    def at(yy, xx):
        return s[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

    sc = at(yi, xi)

    def vertex(a, b, c):
        den = a - 2.0 * b + c
        off = torch.where(den.abs() > 1e-6, (a - c) / (2.0 * den),
                          torch.zeros_like(den))
        return off.clamp(-0.5, 0.5)

    return (vertex(at(yi, xi - 1), sc, at(yi, xi + 1)),
            vertex(at(yi - 1, xi), sc, at(yi + 1, xi)))


def orb(img: torch.Tensor, cfg: dict, dtype=torch.float32) -> dict:
    """ORB on a (H, W) u8 image with the settings ``cfg`` (``max_features``,
    ``levels``, ``scale_factor``, ``threshold``, ``fast_n``, ``blur_size``,
    ``blur_sigma``). Returns {x, y, strength, orientation, level, valid,
    descriptors (K, 256) u8 bits}, K = max_features, strongest first."""
    img = img.contiguous()
    h, w = img.shape
    dev = img.device
    levels, sf = cfg["levels"], cfg["scale_factor"]
    budgets = level_budgets(cfg["max_features"], levels, sf)
    parts = []
    for lv, (lh, lw) in enumerate(pyramid_sizes(h, w, levels, sf)):
        if lh < PATCH_DIAMETER + 2 or lw < PATCH_DIAMETER + 2:
            continue
        k = min(budgets[lv], lh * lw)
        limg = img if lv == 0 else scale_bilinear(img, lh, lw, dtype)
        s_raw = fast_strengths(limg, cfg["threshold"], cfg["fast_n"])
        s = torch.where(_interior(lh, lw, PATCH_RADIUS, dev), nms3x3(s_raw),
                        0.0)
        vals, idx = _top_k(s.reshape(-1), k)
        valid = vals > 0
        lx = (idx % lw).to(torch.float32)
        ly = (idx // lw).to(torch.float32)
        deg = _orientation(limg, lx, ly, valid, dtype)
        blurred = gaussian_blur_u8(limg, cfg["blur_size"], cfg["blur_sigma"],
                                   dtype)
        desc = _brief(blurred, lx, ly, deg, valid, dtype)
        rx, ry = _subpixel(s_raw, lx, ly, dtype)
        lxo = lx.to(dtype) + torch.where(valid, rx, torch.zeros_like(rx))
        lyo = ly.to(dtype) + torch.where(valid, ry, torch.zeros_like(ry))
        inv = float(np.float32(1.0 / sf ** lv))
        zero = torch.zeros_like(lxo)
        parts.append({
            "x": torch.where(valid, lxo * inv, zero).to(torch.float32),
            "y": torch.where(valid, lyo * inv, zero).to(torch.float32),
            "strength": torch.where(valid, vals, 0.0),
            "orientation": deg.to(torch.float32),
            "level": torch.full((k,), lv, dtype=torch.int32, device=dev),
            "valid": valid, "descriptors": desc})
    out = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    svals = torch.where(out["valid"], out["strength"], -torch.inf)
    _, sel = _top_k(svals, min(cfg["max_features"], svals.shape[0]))
    return {key: v.index_select(0, sel) for key, v in out.items()}
