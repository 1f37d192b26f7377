"""Checkerboard corner detection via line intersections (mirror of
``compv_tpu/calib/checkerboard.py``).

Canny -> Hough SHT (kernel K4 on the card) -> the two dominant theta
families -> a greedy merge of near-duplicate lines in each -> all
intersections -> the rows x cols window of maximal X-corner (saddle)
response -> orientation flips -> a projective-grid check with the DLT.
Corners come out row-major, +x along columns and +y along rows.

Everything after the Hough lines runs on the device with no host sync.
Intersections use ``torch.cos`` / ``torch.sin``, which may differ from
XLA's by an ulp, so corners agree with the reference within a tolerance
(``tests/test_torch_checkerboard.py``), not bit for bit.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from compv_tpu_torch.calib.homography import compute_homography_dlt
from compv_tpu_torch.core.types import Lines, at_x64_off
from compv_tpu_torch.features.canny import CannyConfig, canny
from compv_tpu_torch.features.hough import HoughShtConfig, hough_sht
from compv_tpu_torch.math.transform import apply_homography

__all__ = ["CheckerboardConfig", "CheckerboardResult",
           "find_chessboard_corners", "line_intersections"]

_PI = np.float32(np.pi)
_DEG = np.float32(np.pi / 180)   # jnp.deg2rad's f32 factor


@dataclass(frozen=True)
class CheckerboardConfig:
    rows: int = 6           # inner-corner rows (pattern lines = rows)
    cols: int = 8
    canny: CannyConfig = CannyConfig(threshold_low=40.0, threshold_high=100.0)
    hough_threshold: float = 0.3   # fraction of the Hough peak
    merge_rho: float = 10.0  # lines closer than this collapse into one
    grid_tolerance: float = 3.0  # max RMS deviation of corners from a
                                 # projective grid (validity check)


class CheckerboardResult(NamedTuple):
    corners: torch.Tensor   # (rows*cols, 2) row-major grid
    valid: torch.Tensor     # () bool: full grid found
    h_lines: Lines
    v_lines: Lines


@at_x64_off(floats=("rho1", "theta1", "rho2", "theta2"))
def line_intersections(rho1, theta1, rho2, theta2):
    """Intersection of x cos(t1) + y sin(t1) = r1 with the t2/r2 line.
    Batched over any broadcast shape."""
    c1, s1 = torch.cos(theta1), torch.sin(theta1)
    c2, s2 = torch.cos(theta2), torch.sin(theta2)
    det = c1 * s2 - c2 * s1
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    x = (rho1 * s2 - rho2 * s1) / det
    y = (rho2 * c1 - rho1 * c2) / det
    return x, y


def _select_family(lines: Lines, theta_center: torch.Tensor, tol, count: int,
                   merge_rho: float):
    """The ``count`` strongest lines within ``tol`` of the family centre
    (circular in pi), near-duplicates merged greedily, ordered by rho.
    Returns (rhos (count,), thetas (count,), number found () i32); unfilled
    slots hold rho 1e9 and sort last."""
    dev = lines.rho.device
    raw_dt = lines.theta - theta_center
    wrapped = raw_dt.abs() > _PI / 2
    theta_c = torch.where(wrapped, lines.theta - torch.sign(raw_dt) * _PI,
                          lines.theta)
    rho_c = torch.where(wrapped, -lines.rho, lines.rho)
    in_fam = lines.valid & ((theta_c - theta_center).abs() < tol)
    s = torch.where(in_fam, lines.strength,
                    torch.full_like(lines.strength, -1.0))

    slot = torch.arange(count, device=dev)
    rhos = torch.full((count,), 1e9, dtype=torch.float32, device=dev)
    thetas = torch.zeros((count,), dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    close_theta = np.float32(6.0) * _DEG
    for _ in range(count):
        i = torch.argmax(s)
        ok = s[i] > 0
        rho_i, th_i = rho_c[i], theta_c[i]
        # the same physical line only if both rho and theta are close
        close = (((rho_c - rho_i).abs() < merge_rho)
                 & ((theta_c - th_i).abs() < close_theta))
        s = torch.where(close, torch.full_like(s, -1.0), s)
        at = slot == n
        rhos = torch.where(at, torch.where(ok, rho_i, 1e9), rhos)
        thetas = torch.where(at, torch.where(ok, th_i, 0.0), thetas)
        n = n + ok.to(torch.int32)
    order = torch.argsort(rhos, stable=True)
    return rhos[order], thetas[order], n


def _saddle(f: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """X-corner response: |(a + c) - (b + e)| of the diagonal pixel pairs at
    radii 3 and 6, nearest-pixel (floor) samples clipped to the image."""
    h, w = f.shape
    resp = torch.zeros_like(px)
    for d in (3.0, 6.0):
        def sample(dx, dy):
            xs = torch.clamp(px + dx, 0.0, w - 1.0)
            ys = torch.clamp(py + dy, 0.0, h - 1.0)
            return f[torch.floor(ys).to(torch.int64),
                     torch.floor(xs).to(torch.int64)]
        a = sample(d, d)
        b = sample(d, -d)
        c = sample(-d, -d)
        e = sample(-d, d)
        resp = resp + ((a + c) - (b + e)).abs()
    return resp


@at_x64_off
def find_chessboard_corners(img: torch.Tensor,
                            config: CheckerboardConfig = CheckerboardConfig()
                            ) -> CheckerboardResult:
    """Detect the (rows x cols) inner-corner grid of a chessboard image."""
    h, w = img.shape
    dev = img.device
    edges = canny(img, config.canny)
    lines = hough_sht(edges, HoughShtConfig(
        threshold=config.hough_threshold,
        max_lines=8 * (config.rows + config.cols), theta_step_deg=1.0,
        max_edge_points=16384))

    # two dominant theta families: strength-weighted histogram over theta
    nbins = 36
    # f32 scalars as device tensors: a CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    pi_t = torch.tensor(_PI, device=dev)
    nbins_t = torch.tensor(np.float32(nbins), device=dev)
    tbin = torch.clamp((lines.theta / pi_t * nbins).to(torch.int64), 0,
                       nbins - 1)
    hist = torch.zeros(nbins, dtype=torch.float32, device=dev).index_add_(
        0, tbin, torch.where(lines.valid, lines.strength,
                             torch.zeros_like(lines.strength)))
    fam1_bin = torch.argmax(hist)
    fam1_theta = (fam1_bin.to(torch.float32) + 0.5) * pi_t / nbins_t
    # second family: max of the histogram at circular distance > 30 deg
    dist = (torch.arange(nbins, device=dev) - fam1_bin).abs()
    dist = torch.minimum(dist, nbins - dist)
    hist2 = torch.where(dist > nbins // 6, hist, torch.full_like(hist, -1.0))
    fam2_bin = torch.argmax(hist2)
    fam2_theta = (fam2_bin.to(torch.float32) + 0.5) * pi_t / nbins_t

    tol = np.float32(20.0) * _DEG
    # 'horizontal' family: theta closer to pi/2; corners row-major
    d1 = (fam1_theta - _PI / 2).abs()
    d2 = (fam2_theta - _PI / 2).abs()
    h_theta = torch.where(d1 < d2, fam1_theta, fam2_theta)
    v_theta = torch.where(d1 < d2, fam2_theta, fam1_theta)

    # up to rows+2 / cols+2 candidates: the board's outer boundary adds up
    # to one line on each side
    nh, nv = config.rows + 2, config.cols + 2
    h_rhos, h_thetas, n_h = _select_family(lines, h_theta, tol, nh,
                                           config.merge_rho)
    v_rhos, v_thetas, n_v = _select_family(lines, v_theta, tol, nv,
                                           config.merge_rho)
    cx, cy = line_intersections(h_rhos[:, None], h_thetas[:, None],
                                v_rhos[None, :], v_thetas[None, :])

    resp = _saddle(img.to(torch.float32), cx, cy)          # (nh, nv)
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    resp = torch.where(inside, resp, torch.full_like(resp, -1e6))

    # the contiguous rows x cols window of maximal summed response (3x3
    # static candidates, first maximum wins)
    offsets = [(r0, c0) for r0 in range(nh - config.rows + 1)
               for c0 in range(nv - config.cols + 1)]
    scores = torch.stack([resp[r0:r0 + config.rows, c0:c0 + config.cols].sum()
                          for r0, c0 in offsets])
    best = torch.argmax(scores)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev)[best]
    r_idx = off[0] + torch.arange(config.rows, device=dev)
    c_idx = off[1] + torch.arange(config.cols, device=dev)

    def window(m):
        return m[r_idx][:, c_idx]

    sel_cx, sel_cy, sel_in = window(cx), window(cy), window(inside)

    # canonical orientation: x increasing along columns, y along rows
    flip_cols = sel_cx[0, -1] < sel_cx[0, 0]
    flip_rows = sel_cy[-1, 0] < sel_cy[0, 0]
    sel_cx = torch.where(flip_cols, sel_cx.flip(1), sel_cx)
    sel_cy = torch.where(flip_cols, sel_cy.flip(1), sel_cy)
    sel_cx = torch.where(flip_rows, sel_cx.flip(0), sel_cx)
    sel_cy = torch.where(flip_rows, sel_cy.flip(0), sel_cy)
    corners = torch.stack([sel_cx.reshape(-1), sel_cy.reshape(-1)], dim=1)

    # validity: enough family lines, every corner inside, and a projective
    # grid (a homography from the unit grid fits with small residual)
    uy, ux = np.mgrid[0:config.rows, 0:config.cols].astype(np.float32)
    unit = torch.from_numpy(np.stack([ux.ravel(), uy.ravel()], 1)).to(dev)
    fit = apply_homography(compute_homography_dlt(unit, corners), unit)
    grid_rms = torch.sqrt(torch.mean(torch.sum((fit - corners) ** 2, dim=1)))
    ok = ((n_h >= config.rows) & (n_v >= config.cols) & sel_in.all()
          & (grid_rms < config.grid_tolerance))

    def fam_lines(rhos, thetas, idx, k):
        return Lines(rhos[idx], thetas[idx],
                     torch.ones(k, dtype=torch.float32, device=dev),
                     torch.ones(k, dtype=torch.bool, device=dev))

    return CheckerboardResult(
        corners=corners, valid=ok,
        h_lines=fam_lines(h_rhos, h_thetas, r_idx, config.rows),
        v_lines=fam_lines(v_rhos, v_thetas, c_idx, config.cols))
