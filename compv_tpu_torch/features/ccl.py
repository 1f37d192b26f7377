"""Connected-component labeling + blob features (mirror of
``compv_tpu/features/ccl.py``).

Reference: CCL-LSL (core/ccl/compv_core_ccl_lsl.cxx:579; result API
base/include/compv/base/compv_ccl.h:141-156). Labels are the minimum flat
index of each component, -1 at background.

Labeling goes through K2a / K2b (``ops/kernels/ccl_kernel.py``): a
union-find kernel on CUDA tensors, which always converges, and the JAX
package's XLA solver (run-min sweeps, then pointer jumping) as its twin on
CPU tensors.

Features follow the reference's run-record formulation: per-row runs
(``extract_runs``), compacted by K3 (``ops/kernels/compact_kernel.py``)
where packed keys fit 32 bits and the run capacity is a multiple of 8 (the
TPU branch, which the port takes on every device), else sorted from the
padded run table; a row with more runs than ``max_runs_per_row``, or a
frame over the compactor's capacity, diverts to the capacity-free pixel
path. Packed u32 keys (``label << x_bits | x0``, sentinel 2^32 - 1) are
carried as int64, and through K3 as their i32 bit pattern.

One deliberate difference: the top-C rows come from a STABLE sort by
descending area, so among equal areas rows are in ascending root order
(ascending ``box_y0 * W`` + the root's column). The reference sorts
unstably there (``ccl.py:338``, ``:618``), so its order among ties is
unspecified; the set of rows is the same whenever the capacity covers
every component.

Spans (``profiling.span``): ``ccl`` around ``ccl_features``, holding
``ccl.label`` (K2a); inside ``ccl_features_from_labels``, ``ccl.runs``
(run records and the row-overflow test), ``ccl.compact`` (K3, its
capacity test and the record sort), ``ccl.stats`` (the segmented
reductions and the top-C), or ``ccl.pixels`` where the pixel path runs.
The host reads two device values on the run-record path (the overflow
and K3's ``ok``) and one more on the pixel path; ``ccl_features`` adds
each call's count to ``profiling.host_syncs()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F

from compv_tpu_torch.ops.kernels import ccl_kernel, compact_kernel
from compv_tpu_torch.profiling import count_host_syncs, span

__all__ = ["CclConfig", "CclResult", "label_components",
           "label_components_seeded", "extract_runs", "ccl_features",
           "ccl_features_from_labels"]

_U32_SENT = 0xFFFFFFFF
_CAP8 = 8192          # compactor capacity: 65536 records, as the reference


@dataclass(frozen=True)
class CclConfig:
    connectivity: int = 8        # LSL uses 8-connectivity
    max_components: int = 256    # fixed feature capacity (top-C by area)
    max_iterations: int = 64     # pointer-jumping rounds of the CPU twin
    max_runs_per_row: int = 128  # run-record capacity of the fast feature
                                 # extractor; rows with more runs divert
                                 # to the pixel path


class CclResult(NamedTuple):
    labels: torch.Tensor          # (H, W) i32, min flat index, -1 background
    num_components: torch.Tensor  # () i32
    area: torch.Tensor            # (C,) i32, descending; ties by root
    box_x0: torch.Tensor          # (C,) i32 bounding boxes
    box_y0: torch.Tensor
    box_x1: torch.Tensor          # inclusive
    box_y1: torch.Tensor
    cx: torch.Tensor              # (C,) f32 centroids
    cy: torch.Tensor
    valid: torch.Tensor           # (C,) bool


def label_components(binary: torch.Tensor, connectivity: int = 8,
                     max_iterations: int = 64) -> torch.Tensor:
    """(H, W) u8/bool -> (H, W) i32 labels. Foreground pixels (> 0) get
    the min flat index of their component; background gets -1."""
    return ccl_kernel.ccl_label(binary, connectivity,
                                max_iterations=max_iterations)


def label_components_seeded(binary: torch.Tensor, init: torch.Tensor,
                            connectivity: int = 8,
                            max_iterations: int = 64) -> torch.Tensor:
    """label_components warm-started from ``init`` (i32: own flat index or
    a previous level's converged labels at foreground pixels; ignored at
    background): each component gets the minimum of init over it. Used by
    MSER's incremental gray-level ladder."""
    return ccl_kernel.ccl_label_seeded(binary, init, connectivity,
                                       max_iterations=max_iterations)


def ccl_features(binary: torch.Tensor, config: CclConfig = CclConfig()
                 ) -> CclResult:
    """Label + extract per-component features, top max_components by area
    (reference: core/ccl/compv_core_ccl_lsl_result.cxx)."""
    with span("ccl"):
        with span("ccl.label"):
            lbl = label_components(binary, config.connectivity,
                                   config.max_iterations)
        res, syncs = _features(lbl, config)
    count_host_syncs("ccl_features", syncs)
    return res


# --------------------------------------------------------------- helpers

def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """x[:, j - 1] at column j, ``fill`` at column 0."""
    return F.pad(x, (1, 0), value=fill)[:, :-1]


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    return F.pad(x, (0, 1), value=fill)[:, 1:]


def _prev1d(x: torch.Tensor, fill) -> torch.Tensor:
    return F.pad(x, (1, 0), value=fill)[:-1]


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _run_starts(fg: torch.Tensor) -> torch.Tensor:
    return fg & ~_shift_right(fg, False)


def extract_runs(lbl: torch.Tensor, k: int):
    """(H, W) i32 labels -> per-row run records ((H, K') label / x0 / x1,
    valid where label >= 0, K' = min(k, ceil(W/2))) + per-row run counts
    (H,) i32. Rows with more than K' runs are truncated to their first K':
    check counts > K' before trusting the records.

    As in the reference: start keys (x << label_bits) | label and end
    columns are min-folded over column pairs (two adjacent columns never
    both start, or both end, a run) and sorted per row; the k-th start
    pairs with the k-th end. Keys are int64, so one packed form serves
    every image size."""
    h, w = lbl.shape
    n = h * w
    lb = max(1, (n - 1).bit_length())
    fg = lbl >= 0
    xi = torch.arange(w, dtype=torch.int64, device=lbl.device)[None, :]
    start = _run_starts(fg)
    end = fg & ~_shift_left(fg, False)
    counts = start.sum(dim=1, dtype=torch.int32)
    wp = -(-w // 2)
    kk = min(k, wp)

    def fold2(a, pad):
        ap = F.pad(a, (0, 2 * wp - w), value=pad)
        return torch.minimum(ap[:, 0::2], ap[:, 1::2])

    key = torch.where(start, (xi << lb) | lbl.to(torch.int64), _U32_SENT)
    ks = torch.sort(fold2(key, _U32_SENT), dim=1).values[:, :kk]
    live = ks != _U32_SENT
    run_lbl = torch.where(live, ks & ((1 << lb) - 1), -1).to(torch.int32)
    run_x0 = torch.where(live, ks >> lb, w).to(torch.int32)
    keye = torch.where(end, xi, w)
    run_x1 = torch.sort(fold2(keye, w), dim=1).values[:, :kk].to(torch.int32)
    return run_lbl, run_x0, run_x1, counts


def run_records(lbl: torch.Tensor, k: int):
    """The run records ``ccl_features_from_labels`` groups: (H, K') int64
    keys ``label << x_bits | x0`` (u32 sentinel 2^32 - 1 at empty slots),
    (H, K') i32 values ``y * (W + 1) + x1``, and the per-row run counts
    (see ``extract_runs``)."""
    h, w = lbl.shape
    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, k)
    x_bits = max(1, w.bit_length())
    # y * (w + 1) + x1 < 2^31 always (labels need h * w < 2^30)
    yy = torch.arange(h, dtype=torch.int32, device=lbl.device)[:, None]
    val = (yy * (w + 1) + run_x1).to(torch.int32)
    keyu = torch.where(run_lbl >= 0,
                       (run_lbl.to(torch.int64) << x_bits)
                       | run_x0.to(torch.int64), _U32_SENT)
    return keyu, val, counts


def _seg_stats_from_runs(label_key, x0, x1, y, w, h, c):
    """Per-component stats from R run records (label_key ascending-sorted,
    invalid = 2^30 at the end; x0/x1/y aligned, i32). Returns
    (num, area, minx, miny, maxx, maxy, cx, cy, valid) of the top-``c``
    components by area.

    The reference's segmented scans, with its int32 bounds: sums are
    prefix differences at segment boundaries, and sum-x / sum-y are split
    into hi/lo parts whose int32 prefix sums stay exact, rendered as
    f32(hi) * 2^s + f32(lo) in f32 as the reference does."""
    big = 1 << 30
    r = label_key.shape[0]
    dev = label_key.device
    is_first = (label_key != _prev1d(label_key, -1)) & (label_key < big)
    vrun = label_key < big
    num = is_first.sum(dtype=torch.int32)
    segid = torch.cumsum(is_first, 0, dtype=torch.int32)    # 1-based, 0=pre
    length = torch.where(vrun, x1 - x0 + 1, 0)

    def psum(part):
        cs = torch.cumsum(part, 0, dtype=torch.int32)
        exc = _prev1d(cs, 0)
        u = torch.where(is_first, exc, 2 ** 31 - 1)
        nxt = _rev_cummin(u)
        nxt = torch.cat([nxt[1:], cs[-1:]])
        return torch.minimum(nxt, cs[-1]) - exc              # at is_first

    def seg_sum_f32(v, vmax):
        s = 0
        while r * (vmax >> s) >= 2 ** 31 and s < 31:
            s += 1
        if r * (vmax >> s) >= 2 ** 31 or (s and (r << s) >= 2 ** 31):
            raise ValueError("run table too large for exact int32 sums")
        if s == 0:
            return psum(v).to(torch.float32)
        hi, lo = v >> s, v & ((1 << s) - 1)
        return (psum(hi).to(torch.float32) * float(1 << s)
                + psum(lo).to(torch.float32))

    area = psum(length)                # i32-exact: R * w < 2^31 (caller)
    sumx = seg_sum_f32(torch.where(vrun, (x0 + x1) * length // 2, 0), w * w)
    sumy = seg_sum_f32(torch.where(vrun, y * length, 0), h * w)

    # segmented min/max: suffix cummin with monotone segment offsets
    # (requires R * (max(w, h) + 2) < 2^31, checked by the caller)
    def seg_min(v, neutral, m):
        u = torch.where(vrun, v, neutral) + segid * m
        return _rev_cummin(u) - segid * m                    # at is_first

    minx = seg_min(x0, w, w + 1)
    maxx = -seg_min(-x1, 1, w + 2)
    maxy = -seg_min(-y, 1, h + 2)
    miny = label_key // w

    # top-C by area: one descending sort over R slots (stable: ties keep
    # ascending slot = ascending root order)
    tkey = torch.where(is_first, -area, big)
    tk_s, pos_s = torch.sort(tkey, stable=True)
    kk = min(c, r)
    valid = F.pad(tk_s[:kk] < 0, (0, c - kk), value=False)
    pos = F.pad(pos_s[:kk], (0, c - kk), value=0)

    def pick(arr):
        return torch.where(valid, arr[pos], torch.zeros((), dtype=arr.dtype,
                                                        device=dev))

    a = pick(area)
    m00 = torch.clamp(a, min=1).to(torch.float32)
    return (num, a, pick(minx), pick(miny), pick(maxx), pick(maxy),
            pick(sumx) / m00, pick(sumy) / m00, valid)


def _result(lbl, stats) -> CclResult:
    num, area, minx, miny, maxx, maxy, cx, cy, valid = stats
    return CclResult(lbl, num, area, minx, miny, maxx, maxy, cx, cy, valid)


def ccl_features_from_labels(lbl: torch.Tensor, config: CclConfig = CclConfig()
                             ) -> CclResult:
    """Feature extraction given a label map (the reference benchmarks box
    extraction separately from labeling, speed_compare:181-186).

    Labels are constant along horizontal foreground runs, so per-run
    records (label, y, x0, x1) carry all box / area / centroid information:
    runs are extracted per row, grouped by label with one sort over the
    records, and reduced with segmented scans."""
    return _features(lbl, config)[0]


def _features(lbl: torch.Tensor, config: CclConfig) -> tuple:
    """``ccl_features_from_labels`` and the number of device values it
    read on the host."""
    h, w = lbl.shape
    c = config.max_components
    kk = min(config.max_runs_per_row, -(-w // 2))
    r = h * kk
    if not r * (max(w, h) + 2) < 2 ** 31:
        return _ccl_features_pixels(lbl, config), 1

    with span("ccl.runs"):
        keyu, val, counts = run_records(lbl, kk)
        overflow = bool((counts > kk).any())
    syncs = 1
    if overflow:
        return _ccl_features_pixels(lbl, config), syncs + 1
    lb_bits = max(1, (h * w - 1).bit_length())
    x_bits = max(1, w.bit_length())

    with span("ccl.compact"):
        if lb_bits + x_bits <= 32 and kk % 8 == 0:
            # the compactor shrinks the record sort from H * K padded
            # slots to an 8-aligned concatenation of the rows' runs
            ka, vb, total, okc = compact_kernel.compact_rows(
                keyu.to(torch.int32), val, counts, _CAP8)
            fits = bool(okc)
            syncs += 1
            if fits:
                kuc = ka.to(torch.int64) & _U32_SENT
                # slots past the ragged total are unwritten: sentinel them
                slots = torch.arange(_CAP8 * 8, device=lbl.device)
                kuc = torch.where(slots < total, kuc, _U32_SENT)
                ku, order = torch.sort(kuc, stable=True)
                vs = vb[order]
        else:
            fits = True
            ku, order = torch.sort(keyu.reshape(-1), stable=True)
            vs = val.reshape(-1)[order]
    if not fits:
        return _ccl_features_pixels(lbl, config), syncs + 1

    with span("ccl.stats"):
        # (label << x_bits | x0) groups by label and orders runs by x0
        # within a segment; the value packs (y, x1)
        sentinel = ku == _U32_SENT
        ks = torch.where(sentinel, 1 << 30, ku >> x_bits).to(torch.int32)
        x0s = torch.where(sentinel, w, ku & ((1 << x_bits) - 1)
                          ).to(torch.int32)
        x1s, ys = vs % (w + 1), vs // (w + 1)
        return (_result(lbl, _seg_stats_from_runs(ks, x0s, x1s, ys, w, h, c)),
                syncs)


def _ccl_features_pixels(lbl: torch.Tensor, config: CclConfig) -> CclResult:
    """Capacity-free pixel-sort extraction: the fallback when a row exceeds
    max_runs_per_row. One stable sort of [label, flat index], then
    per-segment reductions. Sums are exact int64 here on every image size
    (the reference keeps raw f32 prefix sums past ~8 MP, which drift).
    The host reads one device value (the component count)."""
    with span("ccl.pixels"):
        h, w = lbl.shape
        n = h * w
        c = config.max_components
        big = 1 << 30
        dev = lbl.device
        flat = lbl.reshape(-1)
        key = torch.where(flat >= 0, flat, big)
        key_s, fidx_s = torch.sort(key, stable=True)     # raster order inside
        is_first = (key_s != _prev1d(key_s, -1)) & (key_s < big)
        vmask = key_s < big
        num = is_first.sum(dtype=torch.int32)
        seg = torch.cumsum(is_first, 0) - 1              # segment of each slot
        seg = torch.where(vmask, seg, 0)
        nseg = max(int(num), 1)
        x = fidx_s % w
        y = fidx_s // w

        def seg_reduce(v, how, init):
            out = torch.full((nseg,), init, dtype=torch.int64, device=dev)
            return out.scatter_reduce_(0, seg[vmask], v[vmask], reduce=how)

        area_seg = seg_reduce(torch.ones_like(x), "sum", 0)
        sumx_seg = seg_reduce(x, "sum", 0)
        sumy_seg = seg_reduce(y, "sum", 0)
        minx_seg = seg_reduce(x, "amin", w)
        maxx_seg = seg_reduce(x, "amax", -1)
        maxy_seg = seg_reduce(y, "amax", -1)

        # top-C by area over slot space, as the reference: f32 areas, stable
        # descending sort (ties: ascending slot = ascending root)
        area_slots = torch.where(is_first, area_seg[seg], 0).to(
            torch.float32)
        tkey = torch.where(is_first, -area_slots, torch.inf)
        neg_s, pos_s = torch.sort(tkey, stable=True)
        kk = min(c, n)
        vals = F.pad(torch.where(neg_s[:kk] < 0, -neg_s[:kk], 0.0),
                     (0, c - kk))
        pos = F.pad(pos_s[:kk], (0, c - kk))
        comp_valid = vals > 0
        sid = seg[pos]

        def pick(arr):
            return torch.where(comp_valid, arr, 0).to(torch.int32)

        m00 = torch.clamp(vals, min=1.0)
        # the reference renders f32(sum) / f32(area); an exact int64 sum
        # rounds once to f32 here
        return CclResult(
            labels=lbl,
            num_components=num,
            area=torch.where(comp_valid, vals.to(torch.int32), 0),
            box_x0=pick(minx_seg[sid]),
            box_y0=pick(key_s[pos] // w),
            box_x1=pick(maxx_seg[sid]),
            box_y1=pick(maxy_seg[sid]),
            cx=torch.where(comp_valid,
                           sumx_seg[sid].to(torch.float32) / m00, 0.0),
            cy=torch.where(comp_valid,
                           sumy_seg[sid].to(torch.float32) / m00, 0.0),
            valid=comp_valid,
        )
