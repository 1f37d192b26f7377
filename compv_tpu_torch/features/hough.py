"""Hough line transforms: SHT (standard) and KHT-style kernel voting
(mirror of ``compv_tpu/features/hough.py``).

SHT: the edge list is the exact top-``max_edge_points`` of the edge map
(all edges when they fit), the accumulator is kernel K4
(``ops/kernels/hough_kernel.py``; its twin on CPU tensors), then the
reference's 4-neighbour NMS with two survivors per 64-bin rho segment and
an exact top-K. With the reference's f32 trig table
(``features/hough_trig.py``) the accumulator and the ``Lines`` are
bit-equal to the reference's.

KHT: orientation-weighted voting at the gradient-normal angle (+-1 bin),
a 3E-element scatter of votes 1.0 and 0.5 (exact in f32 in any order),
with SHT's rho arithmetic. Its angle comes from ``torch.atan2``, which may
differ from XLA's ``arctan2`` by an ulp and so move a point's centre bin.

The f32 arithmetic follows the reference as it runs, jitted on XLA:CPU,
which fuses ``a*b + c`` into one multiply-add (the rho of a vote, the rho
of a peak) and multiplies by the reciprocal of a constant divisor.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from compv_tpu_torch.core.types import Lines
from compv_tpu_torch.features.hough_trig import theta_count, theta_table
from compv_tpu_torch.ops.kernels import hough_kernel
from compv_tpu_torch.ops.kernels.hough_kernel import (fma_f32, n_rho_bins,
                                                      rho_bins)
from compv_tpu_torch.ops.topk import top_k, top_k_2d

__all__ = ["HoughShtConfig", "hough_sht", "hough_sht_stats",
           "hough_lines_to_cartesian", "HoughKhtConfig", "hough_kht"]


@dataclass(frozen=True)
class HoughShtConfig:
    rho: float = 1.0             # rho resolution
    theta_step_deg: float = 1.0  # theta resolution
    threshold: float = 100       # min votes; values < 1.0 mean a fraction
                                 # of the peak accumulator value
    max_lines: int = 64          # fixed output capacity
    max_edge_points: int = 65536  # fixed edge-list capacity; if exceeded
                                  # the strongest edges are kept and
                                  # hough_sht_stats reports truncation


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _edge_list(edges: torch.Tensor, capacity: int,
               strengths: torch.Tensor | None = None):
    """All edge pixels if they fit in ``capacity``, else the ``capacity``
    strongest (ranked by ``strengths`` when given, else by the map itself);
    exact top-k, lower flat index first among ties. Returns (x, y, valid)."""
    h, w = edges.shape
    k = min(capacity, h * w)
    rank = (edges if strengths is None
            else torch.where(edges > 0, strengths, torch.zeros_like(strengths)))
    vals, idx = top_k_2d(rank, k)
    return ((idx % w).to(torch.float32), (idx // w).to(torch.float32),
            vals > 0)


def _accumulate(x, y, valid, weights, n_theta: int, rho_max: float,
                rho_step: float, theta_step_deg: float) -> torch.Tensor:
    """(A, R) f32 accumulator: every valid edge point votes its weight at
    every theta. K4 on CUDA tensors, its twin on CPU tensors."""
    cos_t, sin_t = theta_table(theta_step_deg, x.device)
    w_row = (weights * valid).to(torch.int32)
    return hough_kernel.sht_accumulate(x, y, w_row, n_theta, rho_max,
                                       rho_step, cos_t, sin_t
                                       ).to(torch.float32)


def _acc_nms_topk(acc: torch.Tensor, threshold: torch.Tensor,
                  max_lines: int, rho_max: float, rho_step: float,
                  theta_step: float) -> Lines:
    """4-neighbour NMS on the accumulator, the top-2 survivors of every
    64-bin rho segment, then the exact top-K (``hough.py:113-160``)."""
    n_theta, n_rho = acc.shape
    dev = acc.device
    p = torch.nn.functional.pad(acc, (1, 1, 1, 1))

    def sl(dy, dx):
        return p[1 + dy:1 + dy + n_theta, 1 + dx:1 + dx + n_rho]

    is_max = ((acc > sl(0, -1)) & (acc >= sl(0, 1))
              & (acc > sl(-1, 0)) & (acc >= sl(1, 0)))
    kept = torch.where(is_max & (acc >= threshold), acc,
                       torch.zeros_like(acc))

    seg = 64
    nseg = -(-n_rho // seg)
    k3 = torch.nn.functional.pad(kept, (0, nseg * seg - n_rho)
                                 ).reshape(n_theta, nseg, seg)
    a1 = torch.argmax(k3, dim=-1)
    m1 = torch.gather(k3, -1, a1[..., None])[..., 0]
    iota = torch.arange(seg, device=dev)
    k3b = torch.where(iota == a1[..., None], torch.full_like(k3, -1.0), k3)
    a2 = torch.argmax(k3b, dim=-1)
    m2 = torch.gather(k3b, -1, a2[..., None])[..., 0]

    cand_vals = torch.stack([m1, m2], -1).reshape(-1)
    seg_base = torch.arange(nseg, dtype=torch.int32, device=dev) * seg
    cand_rbin = (seg_base[None, :, None]
                 + torch.stack([a1, a2], -1).to(torch.int32)).reshape(-1)
    cand_tbin = torch.arange(n_theta, dtype=torch.int32, device=dev)[
        :, None, None].expand(n_theta, nseg, 2).reshape(-1)

    vals, idx = top_k(cand_vals, max_lines)
    valid = vals > 0
    tbin = cand_tbin[idx].to(torch.float32)
    rbin = cand_rbin[idx].to(torch.float32)
    zero = torch.zeros_like(vals)
    # rbin * rho_step - rho_max as XLA:CPU fuses it: one multiply-add
    rho = fma_f32(rbin, _f32(rho_step, dev), -_f32(rho_max, dev))
    return Lines(
        rho=torch.where(valid, rho, zero),
        theta=torch.where(valid, tbin * _f32(theta_step, dev), zero),
        strength=torch.where(valid, vals, zero),
        valid=valid,
    )


def _hough_sht_impl(edges, strengths, config: HoughShtConfig):
    h, w = edges.shape
    theta_step = float(np.deg2rad(config.theta_step_deg))
    n_theta = theta_count(config.theta_step_deg)
    rho_max = float(np.hypot(h, w))
    x, y, valid = _edge_list(edges, config.max_edge_points, strengths)
    acc = _accumulate(x, y, valid, torch.ones_like(x), n_theta, rho_max,
                      config.rho, config.theta_step_deg)
    thr = (_f32(config.threshold, edges.device) if config.threshold >= 1.0
           else _f32(config.threshold, edges.device) * acc.max())
    lines = _acc_nms_topk(acc, thr, config.max_lines, rho_max, config.rho,
                          theta_step)
    return lines, (edges > 0).sum()


def hough_sht(edges: torch.Tensor, config: HoughShtConfig = HoughShtConfig(),
              strengths: torch.Tensor | None = None) -> Lines:
    """Standard Hough transform on a binary edge map (u8, nonzero = edge).
    Optional ``strengths`` (e.g. gradient magnitude) ranks edge retention
    if the map overflows ``config.max_edge_points``."""
    return _hough_sht_impl(edges, strengths, config)[0]


def hough_sht_stats(edges: torch.Tensor,
                    config: HoughShtConfig = HoughShtConfig(),
                    strengths: torch.Tensor | None = None):
    """Like hough_sht but also returns accumulation stats so vote loss is
    never silent: dict(n_edges, capacity, truncated)."""
    lines, n_edges = _hough_sht_impl(edges, strengths, config)
    n = int(n_edges)
    return lines, {"n_edges": n, "capacity": config.max_edge_points,
                   "truncated": n > config.max_edge_points}


def hough_lines_to_cartesian(lines: Lines, width: int, height: int
                             ) -> torch.Tensor:
    """Polar (rho, theta) -> segment endpoints clipped to a long span, like
    the reference's toCartesian. Returns (L, 4) [x0, y0, x1, y1]."""
    c = torch.cos(lines.theta)
    s = torch.sin(lines.theta)
    x0 = c * lines.rho
    y0 = s * lines.rho
    span = _f32(np.hypot(width, height), lines.rho.device)
    return torch.stack([x0 - span * s, y0 + span * c,
                        x0 + span * s, y0 - span * c], dim=1)


# ---------------------------------------------------------------- KHT-style

@dataclass(frozen=True)
class HoughKhtConfig:
    rho: float = 1.0
    theta_step_deg: float = 0.5
    threshold_ratio: float = 0.25   # of the peak accumulator vote
    max_lines: int = 64
    min_votes: float = 30.0         # absolute significance floor
    max_edge_points: int = 8192     # strongest-gradient retention


def hough_kht(edges: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
              config: HoughKhtConfig = HoughKhtConfig()) -> Lines:
    """KHT-style orientation-weighted Hough: each edge pixel votes only near
    its structure-tensor orientation (+-1 theta bin), 1.0 at the centre and
    0.5 beside it. Needs the gradients used to build ``edges`` (e.g. from
    features.edges.sobel_gradients)."""
    h, w = edges.shape
    dev = edges.device
    theta_step = float(np.deg2rad(config.theta_step_deg))
    n_theta = theta_count(config.theta_step_deg)
    rho_max = float(np.hypot(h, w))
    n_rho = n_rho_bins(rho_max, config.rho)

    # +1 floor keeps edge pixels whose own gradient vanishes
    rank = torch.where(edges > 0, 1.0 + gx * gx + gy * gy,
                       torch.zeros_like(gx))
    vk, ik = top_k_2d(rank, min(config.max_edge_points, h * w))
    x = (ik % w).to(torch.float32)
    y = (ik // w).to(torch.float32)
    valid = vk > 0
    xi, yi = ik % w, ik // w
    # structure tensor over the 3x3 hood (sign-invariant orientation)
    p_gx = torch.nn.functional.pad(gx, (1, 1, 1, 1))
    p_gy = torch.nn.functional.pad(gy, (1, 1, 1, 1))
    jxx = torch.zeros_like(gx)
    jxy = torch.zeros_like(gx)
    jyy = torch.zeros_like(gx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            gxs = p_gx[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            gys = p_gy[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            jxx = jxx + gxs * gxs
            jxy = jxy + gxs * gys
            jyy = jyy + gys * gys
    ang_map = 0.5 * torch.atan2(2.0 * jxy, jxx - jyy)
    ang = ang_map[yi, xi]
    ang = torch.where(ang < 0, ang + _f32(np.pi, dev), ang)
    tcenter = torch.round(ang / _f32(theta_step, dev)).to(torch.int64) \
        % n_theta

    cos_t, sin_t = theta_table(config.theta_step_deg, dev)
    acc = torch.zeros((n_theta, n_rho), dtype=torch.float32, device=dev)
    for dt in (-1, 0, 1):
        tb = (tcenter + dt) % n_theta
        rb = rho_bins(x, y, cos_t[tb], sin_t[tb], rho_max, config.rho)
        wgt = torch.where(valid, 1.0 if dt == 0 else 0.5, 0.0)
        acc.index_put_((tb, rb.to(torch.int64)), wgt, accumulate=True)

    peak = torch.clamp(acc.max(), min=1.0)
    thr = torch.clamp(peak * _f32(config.threshold_ratio, dev),
                      min=config.min_votes)
    return _acc_nms_topk(acc, thr, config.max_lines, rho_max, config.rho,
                         theta_step)
