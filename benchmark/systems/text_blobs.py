"""Text-blob extraction on a scanned page, per request: the global
binarisation ``compv_tpu_torch.image.threshold.threshold_global(page,
127, inverse=True)`` (dark text, ``page < 128``, is the foreground), LSL
connected components with every component's features
(``compv_tpu_torch.features.ccl.ccl_features``: K2a, run records, K3,
segmented stats) and MSER on the gray page
(``compv_tpu_torch.features.mser.mser_detect``: the 51-level ladder, K2b
at each changed level, the stability rules). Each page of a pool is seen
once per cycle; a caller reads every glyph's box and the regions back.

What the check compares, for the sampled requests, from what the timed
path returned: the label map, every component's area and box, its
centroid, and the MSER regions with their variation, each paired with the
reference's by value, and the order of the components and of the regions
position by position. The reference
(``reference/ccl.py``, ``reference/mser.py``) recomputes each from the
page alone, with no capacity: a program result that clipped shows as a
mismatch, and ``capacity_clipped`` counts the clip itself (MSER's
``overflowed`` and the components beyond ``max_components``). The
control is the reference with its areas, centroids and variations in
bfloat16.
"""
from __future__ import annotations

import importlib
import math
from collections import Counter

import torch

from benchmark.reference import ccl as ref_ccl, mser as ref_mser

CCL = "compv_tpu_torch.features.ccl"
MSER = "compv_tpu_torch.features.mser"
ROW = ("area", "box_x0", "box_y0", "box_x1", "box_y1")
REGION = ("seed_x", "seed_y", "level", "area", "box_x0", "box_y0",
          "box_x1", "box_y1")


def _table(res, fields, keep) -> torch.Tensor:
    """(K, len(fields)) int64 rows of ``res`` where ``keep``, on the host."""
    return torch.stack([getattr(res, f)[keep].long() for f in fields],
                       1).cpu()


def program_view(blobs, regions, capacity: int) -> dict:
    """The comparable parts of one request's ``CclResult`` and
    ``MserResult``."""
    v, k = blobs.valid, regions.valid
    num = int(blobs.num_components)
    return {"labels": blobs.labels, "num": num,
            "rows": _table(blobs, ROW, v),
            "cx": blobs.cx[v].double().cpu(), "cy": blobs.cy[v].double().cpu(),
            "regions": _table(regions, REGION, k),
            "var": regions.variation[k].double().cpu(),
            "clipped": int(regions.overflowed) + max(0, num - capacity)}


def reference_view(page, port_config: dict, dtype=None) -> dict:
    """The same parts from the reference; ``dtype`` None is the reference
    itself (float64 features, float32 variations as the configuration
    states, and the exact float64 variations), bfloat16 the control."""
    t = port_config["threshold"]
    binary = page <= t if port_config["inverse"] else page > t
    comps = ref_ccl.ccl(binary, port_config["ccl"]["connectivity"],
                        dtype or torch.float64)
    regs = ref_mser.mser(page, port_config["mser"], dtype or torch.float32)
    rows = torch.stack([getattr(comps, f) for f in ROW], 1).cpu()
    return {"labels": comps.labels, "num": comps.num, "rows": rows,
            "cx": comps.cx.cpu(), "cy": comps.cy.cpu(),
            "regions": torch.stack([getattr(regs, f) for f in REGION],
                                   1).cpu(),
            "var": regs.variation.double().cpu(),
            "var64": regs.var64.cpu(), "clipped": 0}


def keyed(rows: torch.Tensor) -> dict:
    """{(row, occurrence): position} of a table's rows, so that the k-th of
    equal rows in one table pairs with the k-th in the other."""
    seen, out = Counter(), {}
    for i, row in enumerate(map(tuple, rows.tolist())):
        out[row, seen[row]] = i
        seen[row] += 1
    return out


def pair(a: torch.Tensor, b: torch.Tensor):
    """Positions of the rows of ``a`` and ``b`` that pair by value, and the
    count of rows of either that find no partner."""
    ka, kb = keyed(a), keyed(b)
    both = [(i, kb[k]) for k, i in ka.items() if k in kb]
    i, j = (list(t) for t in zip(*both)) if both else ([], [])
    return i, j, len(ka) + len(kb) - 2 * len(both)


def order_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Positions at which ``a``'s row differs from ``b``'s, a position
    that only one table has included."""
    m = min(len(a), len(b))
    return int((a[:m] != b[:m]).any(1).sum()) + abs(len(a) - len(b))


def worst(gaps: torch.Tensor, unpaired: bool) -> float:
    """The largest of ``gaps``; where no row paired although some row
    exists, nothing was compared and the number is infinite."""
    if gaps.numel():
        return float(gaps.max())
    return math.inf if unpaired else 0.0


def numbers(c: dict, r: dict) -> dict:
    """The compared numbers of one request ``c`` against the reference
    ``r``. Rows and regions pair by value (``pair``): a row that finds no
    partner counts in ``ccl_feature_mismatch`` / ``mser_region_mismatch``,
    the centroids and variations are compared between partners, and the
    two orders (``CclResult``'s area descending with ties by root,
    ``MserResult``'s rank) position by position."""
    i, j, ccl_gap = pair(c["rows"], r["rows"])
    cerr = torch.cat([(c["cx"][i] - r["cx"][j]).abs(),
                      (c["cy"][i] - r["cy"][j]).abs()])
    i, j, mser_gap = pair(c["regions"], r["regions"])
    exact = r["var64"][j]
    gap = (c["var"][i] - exact).abs()
    rel = torch.where(exact > 0, gap / exact.clamp(min=1e-300), gap)
    return {
        "ccl_label_mismatch_px": int((c["labels"].long()
                                      != r["labels"]).sum()),
        "ccl_feature_mismatch": ccl_gap + abs(c["num"] - r["num"]),
        "ccl_order_mismatch": order_gap(c["rows"], r["rows"]),
        "ccl_centroid_err_px": worst(cerr, ccl_gap > 0),
        "mser_region_mismatch": mser_gap,
        "mser_order_mismatch": order_gap(c["regions"], r["regions"]),
        "mser_variation_rel_err": worst(rel, mser_gap > 0),
        "capacity_clipped": c["clipped"]}


class System:
    frames_per_request = 1
    capture = [f"{CCL}:ccl_features", f"{MSER}:mser_detect"]

    def __init__(self, config: dict, traffic: dict, make_inputs, seed: int,
                 device):
        self.cfg = config
        self.traffic = traffic
        self.make_inputs = make_inputs
        self.seed = seed
        self.device = torch.device(device)
        self.truth = {}

    # ----------------------------------------------------------- timed path

    def setup(self):
        self.threshold = importlib.import_module(
            "compv_tpu_torch.image.threshold")
        self.ccl = importlib.import_module(CCL)
        self.mser = importlib.import_module(MSER)
        pc = self.cfg["port_config"]
        self.ccl_cfg = self.ccl.CclConfig(**pc["ccl"])
        self.mser_cfg = self.mser.MserConfig(**pc["mser"])
        self.pages = self.make_inputs(self.traffic, self.seed, self.device)
        for i in range(self.cfg["warmup_requests"]):
            self.serve(i)

    def serve(self, i: int):
        """One page; its blobs' features and its regions read to the host
        as a caller reads them."""
        pc = self.cfg["port_config"]
        page = self.pages[i % len(self.pages)]
        binary = self.threshold.threshold_global(page, pc["threshold"],
                                                 inverse=pc["inverse"])
        blobs = self.ccl.ccl_features(binary, self.ccl_cfg)
        regions = self.mser.mser_detect(page, self.mser_cfg)
        return (tuple(t.cpu() for t in blobs[1:]),
                tuple(t.cpu() for t in regions))

    def release(self):
        self.threshold = self.ccl = self.mser = None

    # ----------------------------------------------------------- the check

    def _reference(self, page_id: int, dtype=None) -> dict:
        return reference_view(self.pages[page_id], self.cfg["port_config"],
                              dtype)

    def _numbers(self, views: dict) -> dict:
        """Worst of each number over ``views`` (page id -> [view])."""
        worst = {}
        for page_id, outs in views.items():
            if page_id not in self.truth:
                self.truth[page_id] = self._reference(page_id)
            for c in outs:
                for k, v in numbers(c, self.truth[page_id]).items():
                    worst[k] = max(worst.get(k, v), v)
        return worst

    def check(self, captured: dict) -> list:
        cap = self.cfg["port_config"]["ccl"]["max_components"]
        views = {}
        for i, (recs, _) in captured.items():
            by = {r["fn"]: r["out"] for r in recs}
            views.setdefault(i % len(self.pages), []).append(
                program_view(by["ccl_features"], by["mser_detect"], cap))
        self.seen = self._numbers(views)
        return [{"name": k, "value": self.seen.get(k), "limit": lim}
                for k, lim in self.cfg["check"]["limits"].items()]

    def control_readings(self, captured: dict) -> dict:
        """The control's numbers over the captured requests' pages: the
        reference in bfloat16 in the program's place."""
        ids = sorted({i % len(self.pages) for i in captured})
        return self._numbers({p: [self._reference(p, torch.bfloat16)]
                              for p in ids})
