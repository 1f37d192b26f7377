"""The object-recognition pair: ``compv_tpu_torch.slam.frontend.match_pair
(object, frame)`` per request, each frame of a pool seen once per cycle.

What the timed path produces and the check compares, for the sampled
requests: both images' ORB keypoints and descriptors (K1 inside), the
KNN-2 matches that pass the ratio test, the homography's inlier count,
and the homography itself through the reference's matches that it keeps
as inliers. The reference (``reference/``) recomputes each from the same
images: plain ORB, plain Hamming KNN-2 and ratio test, plain RANSAC
homography, all without the program's outputs. ``h_corner_px`` (the
panel corners' distance between the two homographies) is read but not
compared: on the card the program's float32 refinement sits as far from
the float64 fit as the bfloat16 control does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import scenes
from benchmark.reference import geometry, orb as ref_orb
from benchmark.reference.matcher import knn2_ratio

FRONTEND = "compv_tpu_torch.slam.frontend"


def build_dataclass(cls, values: dict):
    """``cls()`` with ``values`` replacing its fields; a nested dict
    replaces the fields of a nested dataclass."""
    inst = cls()
    changes = {}
    for key, val in values.items():
        cur = getattr(inst, key)
        if isinstance(val, dict) and dataclasses.is_dataclass(cur):
            val = build_dataclass(type(cur), val)
        changes[key] = val
    return dataclasses.replace(inst, **changes)


def orb_settings(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("max_features", "levels", "scale_factor",
                                "threshold", "fast_n", "blur_size",
                                "blur_sigma")}


def orb_numbers(cands: list, refs: list) -> dict:
    """Keypoint slots that differ (valid, level, or position by more than
    1e-3 px), as % of the slots; descriptor bits that differ among the
    valid slots of the same level in both, as % of their bits."""
    slots = bad = bits = bad_bits = 0
    for c, r in zip(cands, refs):
        level = (c["valid"] == r["valid"]) & (c["level"] == r["level"])
        same = (level & ((c["x"] - r["x"]).abs() <= 1e-3)
                & ((c["y"] - r["y"]).abs() <= 1e-3))
        slots += same.numel()
        bad += int((~same).sum())
        both = level & r["valid"]
        d = (c["descriptors"][both] != r["descriptors"][both])
        bits += d.numel()
        bad_bits += int(d.sum())
    return {"kp_mismatch_pct": 100.0 * bad / max(slots, 1),
            "desc_bit_err_pct": 100.0 * bad_bits / max(bits, 1)}


def match_mismatch_pct(c_idx, c_ok, r_idx, r_ok) -> float:
    """Queries whose ratio-test verdict or first train index differs, as %
    of the reference's matches."""
    c_ok, r_ok = c_ok.cpu(), r_ok.cpu()
    diff = (c_ok != r_ok) | (r_ok & (c_idx.cpu().long() != r_idx.cpu().long()))
    return 100.0 * int(diff.sum()) / max(int(r_ok.sum()), 1)


class System:
    frames_per_request = 1
    capture = [f"{FRONTEND}:orb_detect_describe", f"{FRONTEND}:knn_match",
               f"{FRONTEND}:ratio_test", f"{FRONTEND}:find_homography"]

    def __init__(self, config: dict, traffic: dict, make_inputs, seed: int,
                 device):
        self.cfg = config
        self.traffic = traffic
        self.make_inputs = make_inputs
        self.seed = seed
        self.device = torch.device(device)

    # ----------------------------------------------------------- timed path

    def setup(self):
        from compv_tpu_torch.slam import frontend
        self.frontend = frontend
        self.port_cfg = build_dataclass(frontend.FrontendConfig,
                                        self.cfg["port_config"])
        self.obj, self.frames, self.h_gt = self.make_inputs(
            self.traffic, self.seed, self.device)
        for i in range(self.cfg["warmup_requests"]):
            self.serve(i)

    def serve(self, i: int):
        """One request, its result read to the host as a caller reads it."""
        res = self.frontend.match_pair(self.obj, self.frames[i % len(self.frames)],
                                       self.port_cfg)
        return tuple(t.cpu() for t in res)

    def release(self):
        self.frontend = None

    # ----------------------------------------------------------- the check

    def _settings(self):
        o = self.cfg["port_config"]["orb"]
        return orb_settings(o), self.cfg["port_config"]["ratio"], \
            self.cfg["port_config"]["homography"]

    def reference_outputs(self, frame_ids, dtype=torch.float32,
                          quant=geometry.no_quant) -> dict:
        """The reference's ORB, matches and homography for the object
        against each pooled frame in ``frame_ids``."""
        ocfg, ratio, hcfg = self._settings()
        obj = ref_orb.orb(self.obj, ocfg, dtype)
        out = {}
        for f in frame_ids:
            fr = ref_orb.orb(self.frames[f], ocfg, dtype)
            idx, _, ok = knn2_ratio(obj["descriptors"], obj["valid"],
                                    fr["descriptors"], fr["valid"], ratio)
            src = torch.stack([obj["x"], obj["y"]], 1)
            dst = torch.stack([fr["x"][idx], fr["y"][idx]], 1)
            h, inl = geometry.find_homography(
                src, dst, ok, hcfg["num_hypotheses"], hcfg["threshold"],
                quant=quant)
            out[f] = {"orb": [obj, fr], "idx": idx, "ok": ok,
                      "h": h.cpu().numpy(), "inliers": int(inl.sum()),
                      "src": src, "dst": dst}
        return out

    def program_outputs(self, captured: dict) -> dict:
        """What the timed path produced, by pooled frame."""
        out = {}
        for i, (recs, _) in captured.items():
            by = {}
            for r in recs:
                by.setdefault(r["fn"], []).append(r["out"])
            kps = [o.keypoints._asdict() | {"descriptors": o.descriptors}
                   for o in by["orb_detect_describe"]]
            hres = by["find_homography"][0]
            out.setdefault(i % len(self.frames), []).append({
                "orb": kps, "idx": by["knn_match"][0].train_idx[0],
                "ok": by["ratio_test"][0], "h": hres.h.cpu().double().numpy(),
                "inliers": int(hres.num_inliers)})
        return out

    @property
    def threshold(self) -> float:
        return self.cfg["port_config"]["homography"]["threshold"]

    def numbers(self, cand: dict, ref: dict) -> dict:
        """The numbers, worst over the requests of ``cand``; the
        configuration's limits name those compared."""
        h, w = self.obj.shape
        corners = scenes.panel_corners(h, w)
        worst = {}
        for f, outs in cand.items():
            r = ref[f]
            for c in outs:
                vals = orb_numbers(c["orb"], r["orb"])
                vals["match_mismatch_pct"] = match_mismatch_pct(
                    c["idx"], c["ok"], r["idx"], r["ok"])
                vals["h_corner_px"] = float(np.abs(
                    geometry.apply_h(c["h"], corners)
                    - geometry.apply_h(r["h"], corners)).max())
                vals["inlier_gap_pct"] = 100.0 * abs(
                    c["inliers"] - r["inliers"]) / max(r["inliers"], 1)
                recount = int(((geometry.transfer_error(
                    torch.as_tensor(c["h"], dtype=torch.float64,
                                    device=r["src"].device),
                    r["src"].double(), r["dst"].double()) < self.threshold)
                    & r["ok"]).sum())
                vals["h_recount_gap_pct"] = 100.0 * abs(
                    recount - r["inliers"]) / max(r["inliers"], 1)
                for k, v in vals.items():
                    worst[k] = max(worst.get(k, -np.inf), v)
        return worst

    def check(self, captured: dict) -> list:
        cand = self.program_outputs(captured)
        ref = self.reference_outputs(sorted(cand))
        worst = self.numbers(cand, ref)
        self.seen = worst
        return [{"name": k, "value": worst.get(k), "limit": lim}
                for k, lim in self.cfg["check"]["limits"].items()]

    def control_readings(self, captured: dict) -> dict:
        """The control's numbers over the captured requests' frames: the
        reference in the program's place, in bfloat16, judged against the
        reference."""
        frame_ids = sorted({i % len(self.frames) for i in captured})
        ref = self.reference_outputs(frame_ids)
        low = self.reference_outputs(frame_ids, torch.bfloat16,
                                     geometry.bf16_quant)
        return self.numbers({f: [low[f]] for f in frame_ids}, ref)
