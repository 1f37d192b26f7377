"""Plain MSER over a gray-level ladder, the reference of the ``text_blobs``
configuration's MSER (CompV's LMSER, ``core/ccl/compv_core_ccl_lmser.cxx:148``;
stability rules ``compv_core_ccl_lmser_result.h:91-199``; defaults
``base/include/compv/base/compv_ccl.h:23-27``), written from that
description and the rules the program states (``features/mser.py``).

For the dark polarity the image is f = I (bright: 255 - I). The ladder's
candidate levels are t = step, 2 step, ... <= 255, each with its +delta
level min(t + delta, 255). Every level's map f <= t is labelled on its own
from scratch (``reference.ccl.label``, 8-connected, min flat index), never
from the level below. At a candidate level, a candidate is a component
with min_area * N <= area (N pixels; min_area * N truncated, at least 1),
named by its root (seed) pixel. For a candidate R_t:

- variation v = (|R_{t+delta}| - |R_t|) / |R_t|, where R_{t+delta} is the
  component of the +delta level that holds the seed;
- stability: v is compared, as q = round(min(max(v, 0), 8000) * 65536),
  with the q of the candidate that holds the seed at the next candidate
  level up and at the next one down (where the seed is foreground there
  and its component is a candidate); v must not exceed either. The top
  level has no level above, the bottom none below;
- kept when stable, |R_t| <= max_area * N (truncated) and
  v <= max_variation;
- the max_regions kept candidates of least v, ties by level, then seed;
- min-diversity: among those, in that order, a region goes when an
  earlier one is nested with it (one's seed lies in the other at the
  other's level, which is not the lower) and their areas differ by less
  than min_diversity of the larger;
- boxes: the region's pixels at its level; y0 is the seed's row.

v is computed in ``dtype`` (float32, the configuration's precision: one
rounding of a ratio of integers below 2^24) and ranked by that value, as
the program ranks; ``var64`` is the exact ratio in float64.

Departures from the program: no capacity anywhere (no candidate table, no
run tiers, no ``overflowed``), so a program that clips shows as a
mismatch; and no level is skipped (an unchanged map labels the same). The
control (``dtype`` bfloat16) keeps areas and variations in bfloat16, the
thresholds and the ranking included.

Plain ``torch`` only; nothing of the program, JAX or scipy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ccl import label

VAR_SCALE = 65536.0
VAR_CLAMP = 8000.0


class Regions(NamedTuple):
    """The kept regions in rank order, one entry each (int64 / float64)."""
    seed_x: torch.Tensor
    seed_y: torch.Tensor
    level: torch.Tensor
    area: torch.Tensor
    variation: torch.Tensor   # in ``dtype``
    var64: torch.Tensor       # the exact ratio of the integer areas
    box_x0: torch.Tensor
    box_y0: torch.Tensor
    box_x1: torch.Tensor
    box_y1: torch.Tensor


def ladder(level_step: int, delta: int):
    cand = list(range(level_step, 256, level_step))
    plus = [min(t + delta, 255) for t in cand]
    return cand, plus, sorted(set(cand) | set(plus))


def level_labels(img: torch.Tensor, levels, dark: bool = True):
    """(L, H, W) int64 labels of f <= t for each t of ``levels``."""
    f = img.to(torch.int64) if dark else 255 - img.to(torch.int64)
    t = torch.tensor(levels, device=img.device).reshape(-1, 1, 1)
    return label(f[None] <= t, 8)


def mser(img: torch.Tensor, cfg: dict, dtype=torch.float32) -> Regions:
    """The regions of a (H, W) u8 image under ``cfg`` (``MserConfig``'s
    fields by name)."""
    h, w = img.shape
    n = h * w
    dev = img.device
    cand, plus, levels = ladder(cfg["level_step"], cfg["delta"])
    lab = level_labels(img, levels, cfg["dark"]).reshape(len(levels), n)
    row = {t: i for i, t in enumerate(levels)}

    # every component of every level: key = level row * n + root
    fg = lab >= 0
    keys = (torch.arange(len(levels), device=dev)[:, None] * n + lab)[fg]
    comp_key, comp_area = torch.unique(keys, return_counts=True)

    def area_of(rows, roots):
        """Areas of the components (rows, roots) (roots >= 0)."""
        i = torch.searchsorted(comp_key, rows * n + roots)
        return comp_area[i]

    amin = max(int(cfg["min_area"] * n), 1)
    amax = int(cfg["max_area"] * n)
    c_rows = torch.tensor([row[t] for t in cand], device=dev)
    p_rows = torch.tensor([row[p] for p in plus], device=dev)

    # the candidates, ordered by (candidate level, seed)
    crow_of = torch.full((len(levels),), -1, dtype=torch.int64, device=dev)
    crow_of[c_rows] = torch.arange(len(cand), device=dev)
    lvl_row = comp_key // n
    is_cand = crow_of[lvl_row] >= 0
    a_d = comp_area.to(dtype)
    is_cand &= a_d >= amin
    ci = crow_of[lvl_row[is_cand]]               # candidate level index
    seed = (comp_key % n)[is_cand]
    area = comp_area[is_cand]
    area_d = a_d[is_cand]

    # variation against the +delta level's component of the seed
    root_p = lab[p_rows[ci], seed]
    area_p = area_of(p_rows[ci], root_p)
    var = (area_p - area).to(dtype) / area_d
    var64 = (area_p - area).double() / area.double()
    q = torch.round(var.float().clamp(0.0, VAR_CLAMP) * VAR_SCALE).long()

    # q of the candidate holding the seed one candidate level up / down
    ckey = ci * n + seed                          # ascending

    def q_at(cj, ok):
        r = lab[c_rows[cj.clamp(0, len(cand) - 1)], seed]
        key = cj * n + r
        i = torch.searchsorted(ckey, key).clamp(max=ckey.numel() - 1)
        found = ok & (r >= 0) & (ckey[i] == key)
        return found, q[i]

    up_found, q_up = q_at(ci + 1, ci < len(cand) - 1)
    dn_found, q_dn = q_at(ci - 1, ci > 0)
    stable = (~up_found | (q <= q_up)) & (~dn_found | (q <= q_dn))
    keep = (stable & (area_d <= amax)
            & (var <= torch.tensor(cfg["max_variation"], dtype=dtype)))

    # the max_regions of least variation, ties by (level, seed)
    idx = torch.nonzero(keep).squeeze(1)
    idx = idx[torch.sort(var[idx], stable=True).indices][:cfg["max_regions"]]
    ci, seed, area_d = ci[idx], seed[idx], area_d[idx]
    var, var64 = var[idx], var64[idx]

    # min-diversity: i goes when an earlier j is nested with it and similar
    r = idx.numel()
    lrow = c_rows[ci]
    j_in_i = (lab[lrow[:, None], seed[None, :]] == seed[:, None]) \
        & (ci[:, None] >= ci[None, :])
    nested = j_in_i | j_in_i.T
    big = torch.maximum(area_d[:, None], area_d[None, :])
    similar = ((area_d[:, None] - area_d[None, :]).abs() / big
               < torch.tensor(cfg["min_diversity"], dtype=dtype))
    earlier = torch.arange(r, device=dev)
    earlier = earlier[None, :] < earlier[:, None]
    alive = ~(nested & similar & earlier).any(dim=1)

    ci, seed, var, var64 = ci[alive], seed[alive], var[alive], var64[alive]
    area = area_d[alive].double().round().long()     # exact in float32
    lrow = c_rows[ci]
    mask = (lab[lrow] == seed[:, None]).reshape(-1, h, w)
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)
    anyx, anyy = mask.any(dim=1), mask.any(dim=2)
    level = torch.tensor(cand, device=dev)[ci]
    return Regions(
        seed_x=seed % w, seed_y=seed // w, level=level, area=area,
        variation=var, var64=var64,
        box_x0=torch.where(anyx, xs, w).amin(dim=1),
        box_y0=seed // w,
        box_x1=torch.where(anyx, xs, -1).amax(dim=1),
        box_y1=torch.where(anyy, ys, -1).amax(dim=1))
