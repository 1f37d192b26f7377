"""Plain connected-component labeling and component features, the reference
of the ``text_blobs`` configuration's CCL (CompV's LSL result: labels,
areas, boxes, centroids; ``core/ccl/compv_core_ccl_lsl.cxx:579``,
``base/include/compv/base/compv_ccl.h:141-156``).

Labels: each foreground pixel gets the minimum flat index (``y * W + x``)
of its 4- or 8-connected component, background -1. They are reached by
plain min-propagation with pointer jumping until nothing changes. A label
names a pixel of the same component. Each round: every pixel takes the
least label among its own and its neighbours'; the pixel a label names
takes the least of those minima over the pixels that carry the label (so
a minimum found anywhere in a tree of labels reaches its root at once);
then each label is replaced by the label of the pixel it names, twice. A
label never rises and stays at or below the index of its own pixel, so
the rounds stop, and at the fixed point every component carries its
smallest index. Any number of binary maps of one size are labelled in one
batch (the MSER reference labels all its ladder levels so).

Features: area, inclusive boxes, centroids (float64 from exact integer
sums), in the order the program's ``CclResult`` states: area descending,
ties by root ascending. No capacity: every component is kept.

Departures: none in the results. The control (``dtype`` below float64)
keeps the areas and centroids in that dtype, as a program computing them
in a lower precision would.

Plain ``torch`` only; nothing of the program, JAX or scipy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

N4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
N8 = N4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))
JUMPS = 2          # pointer jumps a round


def label(fg: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """(..., H, W) bool -> (..., H, W) int64 labels, the minimum flat index
    of each component within its own map, -1 at background."""
    *lead, h, w = fg.shape
    n = h * w
    fg = fg.reshape(-1, h, w)
    b = fg.shape[0]
    idx = torch.arange(n, device=fg.device).reshape(1, h, w)
    lbl = torch.where(fg, idx, n).reshape(b, n)
    offsets = N8 if connectivity == 8 else N4
    fg = fg.reshape(b, n)
    while True:
        grid = lbl.reshape(b, h, w)
        padded = F.pad(grid, (1, 1, 1, 1), value=n)
        least = grid
        for dy, dx in offsets:
            least = torch.minimum(least, padded[:, 1 + dy:1 + dy + h,
                                                1 + dx:1 + dx + w])
        least = torch.where(fg, least.reshape(b, n), n)
        # background labels name the padded column n, which names itself
        new = F.pad(lbl, (0, 1), value=n).scatter_reduce(
            1, lbl, least, "amin")[:, :n]
        new = torch.minimum(new, least)
        for _ in range(JUMPS):
            new = torch.minimum(new, F.pad(new, (0, 1), value=n)
                                .gather(1, new))
        if torch.equal(new, lbl):
            break
        lbl = new
    return torch.where(fg, lbl, -1).reshape(*lead, h, w)


class Components(NamedTuple):
    labels: torch.Tensor      # (H, W) int64
    num: int
    root: torch.Tensor        # (K,) int64, in the result's order
    area: torch.Tensor        # (K,) int64
    box_x0: torch.Tensor      # (K,) int64, inclusive boxes
    box_y0: torch.Tensor
    box_x1: torch.Tensor
    box_y1: torch.Tensor
    cx: torch.Tensor          # (K,) float64 centroids (``dtype`` values)
    cy: torch.Tensor


def features(labels: torch.Tensor, dtype=torch.float64) -> Components:
    """Every component of a (H, W) label map: area descending, ties by
    root ascending. Areas and centroids are computed in ``dtype`` (exact
    in float64) and returned as int64 / float64."""
    h, w = labels.shape
    flat = labels.reshape(-1)
    pix = torch.nonzero(flat >= 0).squeeze(1)
    roots, inv = torch.unique(flat[pix], return_inverse=True)
    k = roots.numel()
    x, y = pix % w, pix // w

    def seg(v, how, init):
        out = torch.full((k,), init, dtype=torch.int64, device=flat.device)
        return out.scatter_reduce_(0, inv, v, reduce=how)

    count = seg(torch.ones_like(x), "sum", 0)
    area_d = count.to(dtype)
    cx = (seg(x, "sum", 0).to(dtype) / area_d).double()
    cy = (seg(y, "sum", 0).to(dtype) / area_d).double()
    area = area_d.double().round().long()
    x0, x1 = seg(x, "amin", w), seg(x, "amax", -1)
    y1 = seg(y, "amax", -1)
    y0 = roots // w
    order = torch.sort(-area, stable=True).indices     # roots ascend
    return Components(labels, k, roots[order], area[order], x0[order],
                      y0[order], x1[order], y1[order], cx[order], cy[order])


def ccl(binary: torch.Tensor, connectivity: int = 8,
        dtype=torch.float64) -> Components:
    """Labels and features of a (H, W) mask (foreground where non-zero)."""
    return features(label(binary != 0, connectivity), dtype)
