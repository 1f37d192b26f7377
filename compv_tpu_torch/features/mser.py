"""MSER: maximally stable extremal regions (mirror of
``compv_tpu/features/mser.py``).

Reference: LMSER (core/ccl/compv_core_ccl_lmser.cxx:148; stability rules
core/include/compv/core/ccl/compv_core_ccl_lmser_result.h:91-199; defaults
base/include/compv/base/compv_ccl.h:23-27).

The reference's incremental gray-level ladder, as the JAX package runs it:

  phase 1 (a host loop over the 51 levels): level t's labels seed level
    t + step through K2b (``label_components_seeded``); a level whose
    foreground did not change is skipped. Per level, exact component
    areas come from run records (``extract_runs``) grouped by one sort of
    packed (label << len_bits | len) keys, at the smallest run-capacity
    tier that covers the level's widest row. The skip test and the tier
    choice are host decisions: a device-to-host sync for each level and a
    second one for each changed level (module-level ``last_syncs`` holds
    the count of the last call). On CPU tensors K2b's twin gets H * W
    pointer rounds, a bound no component's geodesic diameter exceeds: on
    a bright page the background is one maze-like component that takes
    more than the twin's default 64, where the card's union-find has no
    cap.

  phase 2 (batched small-table math): variation against the +delta level,
    local-minimum stability against the levels above and below through
    per-level sorted (root -> value) tables, top-R by variation, the
    min-diversity rule, and the boxes of the survivors.

Bounded deviations from the exact component tree are the reference's own
(sampled levels, no veto from below-min-area children) and are flagged in
``overflowed`` where a capacity clips.

Spans (``profiling.span``): ``mser`` around ``mser_detect``, holding one
``mser.level`` a ladder level (attribute ``level``, the gray level; 51 at
the defaults) and ``mser.stability`` (phase 2). ``mser_detect`` adds its
syncs to ``profiling.host_syncs()``: ``last_syncs`` plus its own read of
``overflowed``. Host-to-device copies (phase 2's three level-index
tables) are not counted.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from compv_tpu_torch.features.ccl import (extract_runs, label_components,
                                          label_components_seeded)
from compv_tpu_torch.ops.topk import top_k
from compv_tpu_torch.profiling import count_host_syncs, span

__all__ = ["MserConfig", "MserResult", "mser_detect", "mser_region_mask",
           "mser_region_points"]

_BIG = 1 << 30
_U32_SENT = 0xFFFFFFFF
_VAR_SCALE = 65536.0   # variation quantized to i32 fixed point so table
_VAR_CLAMP = 8000.0    # lookups stay exact (clamp * scale * 2 < 2^31)

log = logging.getLogger(__name__)

# host syncs (level skip + tier choice) of the last _mser_impl call
last_syncs = 0


@dataclass(frozen=True)
class MserConfig:
    """Parameter names and defaults follow the reference's LMSER caps
    (base/include/compv/base/compv_ccl.h:23-27)."""
    delta: int = 5               # stability step in GRAY LEVELS
    min_area: float = 0.0002     # fraction of image area
    max_area: float = 0.5
    max_variation: float = 0.5
    min_diversity: float = 0.5
    dark: bool = True            # detect dark-on-bright (I <= t)
    level_step: int = 5          # gray-level quantization of the ladder
    max_regions: int = 128       # fixed output capacity
    max_candidates: int = 1024   # per-level capacity for components with
                                 # area >= min_area; overflow sets
                                 # `overflowed`
    run_tiers: tuple = (112, 320)  # per-row run-record capacities of the
                                 # per-level area extraction, ending in an
                                 # exact ceil(W/2) tier


class MserResult(NamedTuple):
    seed_x: torch.Tensor      # (R,) i32 seed pixel (component min-index)
    seed_y: torch.Tensor
    level: torch.Tensor       # (R,) i32 gray threshold where it is stable
    area: torch.Tensor        # (R,) i32
    variation: torch.Tensor   # (R,) f32 stability score (lower = stabler)
    box_x0: torch.Tensor      # (R,) i32
    box_y0: torch.Tensor
    box_x1: torch.Tensor
    box_y1: torch.Tensor
    valid: torch.Tensor       # (R,) bool
    overflowed: torch.Tensor  # () i32: #levels where a capacity clipped

    def count(self):
        return self.valid.sum()


def _quantize_var(v: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(v, 0.0, _VAR_CLAMP) * _VAR_SCALE
                       ).to(torch.int32)


def _lookup_sorted(table_keys, table_vals, queries, invalid_key):
    """Batched exact-match lookup: (B, C) tables sorted ascending by key
    (invalid entries = invalid_key, at the end), (B, Q) queries ->
    (found (B, Q) bool, vals (B, Q) i32).

    A binary search per query replaces the reference's sort-merge join:
    both return, for a key present in the table, the value of its last
    entry, and ``found`` only for keys present and not invalid. Where a key
    is absent the values differ, and callers read none of them."""
    idx = torch.searchsorted(table_keys.contiguous(), queries.contiguous(),
                             right=True) - 1
    safe = idx.clamp(min=0)
    hit = torch.gather(table_keys, 1, safe)
    found = (idx >= 0) & (hit == queries) & (queries != invalid_key)
    vals = torch.where(found, torch.gather(table_vals, 1, safe), 0)
    return found, vals


def ladder_levels(config: MserConfig):
    """(candidate levels, their +delta levels, all levels ascending): the
    gray levels the ladder labels."""
    cand = list(range(config.level_step, 256, config.level_step))
    plus = [min(t + config.delta, 255) for t in cand]
    return cand, plus, sorted(set(cand) | set(plus))


def _level_candidates(lbl, kk, amin, cap, lb_bits, len_bits):
    """Exact per-component areas of one level's labeling via run records,
    compacted to the (cap,) candidate table of components with area >=
    min_area, in ascending root order. Returns (root, area, over)."""
    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, kk)
    over_runs = (counts > kk).any()
    live = run_lbl >= 0
    length = torch.where(live, run_x1 - run_x0 + 1, 0)
    # one packed key sort: label groups, the length rides in the low bits
    # (int64 keys: no separate form when lb_bits + len_bits > 32)
    keyu = torch.where(live, (run_lbl.to(torch.int64) << len_bits)
                       | length.to(torch.int64), _U32_SENT).reshape(-1)
    ku = torch.sort(keyu).values
    sen = ku == _U32_SENT
    ks = torch.where(sen, _BIG, ku >> len_bits)
    ln = torch.where(sen, 0, ku & ((1 << len_bits) - 1))
    is_first = (ks != F.pad(ks, (1, 0), value=-1)[:-1]) & (ks < _BIG)
    cs = torch.cumsum(ln, 0)
    exc = F.pad(cs, (1, 0))[:-1]
    u = torch.where(is_first, exc, 2 ** 62)
    nxt = torch.cummin(u.flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt[1:], cs[-1:]])
    area = torch.minimum(nxt, cs[-1]) - exc             # valid at is_first

    cand_mask = is_first & (area >= amin)
    ckey = torch.where(cand_mask, ks, _BIG)
    root_s, order = torch.sort(ckey, stable=True)
    area_s = torch.where(cand_mask, area, 0)[order]
    root = torch.where(root_s[:cap] < _BIG, root_s[:cap], -1)
    car = torch.where(root >= 0, area_s[:cap], 0)
    over = (over_runs | (cand_mask.sum() > cap)).to(torch.int32)
    return root.to(torch.int32), car.to(torch.int32), over


def _mser_impl(img: torch.Tensor, config: MserConfig) -> MserResult:
    global last_syncs
    h, w = img.shape
    n = h * w
    dev = img.device
    syncs = 0
    f = img if config.dark else (255 - img.to(torch.int32)).to(torch.uint8)
    fi = f.to(torch.int32)

    all_levels = ladder_levels(config)[2]
    n_lv = len(all_levels)
    # run-capacity tiers, ending in an exact ceil(W/2) tier (clamped only
    # when the int32 area-sum bound forbids it: flagged via counts)
    w_exact = -(-w // 2)
    sum_cap = max((2 ** 31 - 1) // (h * max(w, 1)), 1)
    tiers = sorted({min(t, w_exact, sum_cap) for t in config.run_tiers}
                   | {min(w_exact, sum_cap)})
    cap = min(config.max_candidates, h * tiers[0])
    amin = max(int(config.min_area * n), 1)
    lb_bits = max(1, (n - 1).bit_length())
    len_bits = max(1, w.bit_length())
    idx = torch.arange(n, dtype=torch.int32, device=dev).reshape(h, w)

    # ---------------- phase 1: incremental labeling + per-level records
    labels_flat = torch.empty((n_lv, n), dtype=torch.int32, device=dev)
    cand_root = torch.empty((n_lv, cap), dtype=torch.int32, device=dev)
    cand_area = torch.empty((n_lv, cap), dtype=torch.int32, device=dev)
    over_all = torch.zeros((n_lv,), dtype=torch.int32, device=dev)
    lbl = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    root = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    car = torch.zeros((cap,), dtype=torch.int32, device=dev)
    for i, t in enumerate(all_levels):
        with span("mser.level", level=t):
            fgm = fi <= t
            syncs += 1
            if bool((fgm != (lbl >= 0)).any()):
                init = torch.where(lbl >= 0, lbl, idx)
                lbl = label_components_seeded(fgm, init, 8,
                                              max_iterations=n)
                # tier dispatch: the wide-capacity sorts only where needed
                fgl = lbl >= 0
                starts = fgl & ~F.pad(fgl, (1, 0), value=False)[:, :-1]
                mx = int(starts.sum(dim=1).max()) if h else 0
                syncs += 1
                kk = tiers[sum(int(mx > t_) for t_ in tiers[:-1])]
                root, car, over = _level_candidates(lbl, kk, amin, cap,
                                                    lb_bits, len_bits)
                over_all[i] = over
            labels_flat[i] = lbl.reshape(-1)
            cand_root[i] = root
            cand_area[i] = car
    last_syncs = syncs
    with span("mser.stability"):
        return _stable_regions(img, config, labels_flat, cand_root,
                               cand_area, over_all)


def _stable_regions(img, config, labels_flat, cand_root, cand_area,
                    over_all) -> MserResult:
    """Phase 2 over the ladder's (L, H * W) labels and (L, cap) candidate
    tables."""
    h, w = img.shape
    n = h * w
    dev = img.device
    cand_levels, plus_levels, all_levels = ladder_levels(config)
    pos = {t: i for i, t in enumerate(all_levels)}
    n_cand = len(cand_levels)
    cap = cand_root.shape[1]
    amax = int(config.max_area * n)
    invalid = n + 1
    tbl_root = torch.where(cand_root >= 0, cand_root, invalid)   # (L, cap)
    cand_rows = torch.tensor([pos[t] for t in cand_levels], device=dev)
    plus_rows = torch.tensor([pos[p] for p in plus_levels], device=dev)
    seeds = cand_root[cand_rows]                          # (n_cand, cap)
    areas = cand_area[cand_rows]
    valid_c = seeds >= 0
    seeds0 = torch.where(valid_c, seeds, 0).long()

    # variation: area of the comp containing the seed at the +delta level
    plus_roots = labels_flat[plus_rows[:, None], seeds0]
    found_p, area_plus = _lookup_sorted(
        tbl_root[plus_rows], cand_area[plus_rows],
        torch.where(plus_roots >= 0, plus_roots, invalid), invalid)
    area_sf = torch.clamp(areas.to(torch.float32), min=1.0)
    var = (area_plus - areas).to(torch.float32) / area_sf
    var = torch.where(valid_c & found_p & (area_plus >= areas), var, torch.inf)
    var_q = _quantize_var(var)

    # local-minimum stability vs parent (next cand level up, through the
    # seed) and child (next level down); a missing table entry passes
    ar = torch.arange(n_cand, device=dev)
    up_rows = torch.clamp(ar + 1, max=n_cand - 1)
    dn_rows = torch.clamp(ar - 1, min=0)
    r_up = labels_flat[cand_rows[up_rows][:, None], seeds0]
    r_dn = labels_flat[cand_rows[dn_rows][:, None], seeds0]
    var_tbl_keys = torch.where(valid_c, seeds, invalid)   # sorted rows
    found_ud, vq_ud = _lookup_sorted(
        torch.cat([var_tbl_keys[up_rows], var_tbl_keys[dn_rows]], 0),
        torch.cat([var_q[up_rows], var_q[dn_rows]], 0),
        torch.cat([torch.where(r_up >= 0, r_up, invalid),
                   torch.where(r_dn >= 0, r_dn, invalid)], 0), invalid)
    found_up, found_dn = found_ud[:n_cand], found_ud[n_cand:]
    vq_up, vq_dn = vq_ud[:n_cand], vq_ud[n_cand:]
    is_min_up = torch.where(found_up & (ar[:, None] < n_cand - 1),
                            var_q <= vq_up, True)
    has_dn = (r_dn >= 0) & found_dn & (ar[:, None] > 0)
    is_min_dn = torch.where(has_dn, var_q <= vq_dn, True)
    ok = (valid_c & is_min_up & is_min_dn & (areas <= amax)
          & (var <= config.max_variation))
    score = torch.where(ok, var, torch.inf)

    # ---------------- top-R regions: per-level top-R then global top-R
    r_cap = config.max_regions
    per = min(r_cap, cap)
    if n_cand * per < r_cap:        # the reference's top_k raises here
        raise ValueError(
            f"max_regions={r_cap} exceeds the {n_cand * per} candidate slots "
            f"({n_cand} levels x {per}) of a {img.shape[0]}x{img.shape[1]} "
            f"image")
    neg, posi = top_k(-score, per)                 # (n_cand, per)
    flat_sc = (-neg).reshape(-1)
    vals, sel = top_k(-flat_sc, r_cap)
    valid = torch.isfinite(-vals)
    lvl_i = sel // per                                    # cand-level index
    slot = posi.reshape(-1)[sel]
    sel_seed = torch.where(valid, seeds[lvl_i, slot], 0)
    sel_area = torch.where(valid, areas[lvl_i, slot], 0)
    sel_var = torch.where(valid, var[lvl_i, slot], torch.inf)

    # ---------------- min-diversity (lmser_result.h:91-113)
    rows_i = cand_rows[lvl_i]                             # (R,)
    root_j_at_i = labels_flat[rows_i[:, None], sel_seed[None, :].long()]
    nested = (root_j_at_i == sel_seed[:, None]) & \
        (lvl_i[:, None] >= lvl_i[None, :])
    nested = nested | nested.T
    a_i = sel_area[:, None].to(torch.float32)
    a_j = sel_area[None, :].to(torch.float32)
    rel = (a_i - a_j).abs() / torch.clamp(torch.maximum(a_i, a_j), min=1.0)
    similar = rel < config.min_diversity
    rank = torch.arange(r_cap, device=dev)
    beats = (rank[None, :] < rank[:, None]) & valid[None, :]
    killed = (nested & similar & beats).any(dim=1)
    keep = valid & ~killed

    # ---------------- boxes of the surviving regions, one batched pass
    xi1 = torch.arange(w, dtype=torch.int32, device=dev)
    yi1 = torch.arange(h, dtype=torch.int32, device=dev)
    m = (labels_flat[rows_i] == sel_seed[:, None]).reshape(-1, h, w)
    anyx = m.any(dim=1)                                   # (R, w)
    anyy = m.any(dim=2)                                   # (R, h)
    bx0 = torch.where(anyx, xi1[None, :], _BIG).amin(dim=1)
    bx1 = torch.where(anyx, xi1[None, :], -1).amax(dim=1)
    by1 = torch.where(anyy, yi1[None, :], -1).amax(dim=1)
    by0 = sel_seed // w

    level_arr = torch.tensor(cand_levels, dtype=torch.int32, device=dev)

    def kept(v, fill=0):
        return torch.where(keep, v, fill).to(v.dtype)

    return MserResult(
        seed_x=kept(sel_seed % w),
        seed_y=kept(sel_seed // w),
        level=kept(level_arr[lvl_i]),
        area=kept(sel_area),
        variation=kept(sel_var, torch.inf),
        box_x0=kept(bx0),
        box_y0=kept(by0),
        box_x1=kept(bx1),
        box_y1=kept(by1),
        valid=keep,
        overflowed=over_all.sum(dtype=torch.int32),
    )


def mser_detect(img: torch.Tensor, config: MserConfig = MserConfig()
                ) -> MserResult:
    """Detect MSERs on a (H, W) u8 grayscale image. When a fixed capacity
    clips at any level, ``overflowed`` is non-zero and a warning is
    logged: regions may be missing."""
    if img.dtype != torch.uint8 or img.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 image, got {img.ndim}-D "
                         f"{img.dtype}")
    with span("mser"):
        res = _mser_impl(img, config)
        n_over = int(res.overflowed)
    count_host_syncs("mser_detect", last_syncs + 1)
    if n_over > 0:
        log.warning(
            "MSER capacity overflow at %d level(s): regions may be silently "
            "missing. Raise MserConfig.max_candidates (components with area "
            ">= min_area per level); run capacities auto-tier up to the "
            "exact ceil(W/2) bound and cannot overflow on their own.", n_over)
    return res


def mser_region_mask(img: torch.Tensor, seed_x, seed_y, level,
                     dark: bool = True) -> torch.Tensor:
    """(H, W) bool membership mask of one detected region (the reference's
    per-region point lists, compv_ccl.h:141-156): the level-set labeling at
    the region's gray level, one CCL pass."""
    f = img if dark else (255 - img.to(torch.int32)).to(torch.uint8)
    level = torch.as_tensor(level, dtype=torch.int32, device=img.device)
    binary = (f.to(torch.int32) <= level).to(torch.uint8)
    lbl = label_components(binary, 8, 64)
    return (lbl >= 0) & (lbl == lbl[seed_y, seed_x])


def mser_region_points(mask: torch.Tensor, max_points: int = 4096):
    """(H, W) bool mask -> fixed-capacity point list ((P,) x, (P,) y,
    (P,) valid) in raster order (CompVConnectedComponentPoints)."""
    h, w = mask.shape
    n = h * w
    flat = mask.reshape(-1)
    rank = torch.where(flat, n - torch.arange(n, dtype=torch.int32,
                                              device=mask.device), 0)
    vals, idx2 = top_k(rank, min(max_points, n))
    valid = vals > 0
    return ((idx2 % w).to(torch.int32) * valid,
            (idx2 // w).to(torch.int32) * valid, valid)
