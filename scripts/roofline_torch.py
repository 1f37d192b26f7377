"""Roofline of the port's hot functions on the card: scripts/roofline.py's 8
rows, at its shapes and seeds, through compv_tpu_torch.

For each row: a model of the function itself, stated inline (each input
byte read once and each output byte written once; the operations the
function needs, by the unit that runs them), its bound = max(bytes / the
card's memory rate, the sum over units of operations / that unit's peak),
which of the two sets it, the time measured, and share = bound / time.
Times are bench_torch.py's dependent-chain slope (the BA rows: a chain of
steps, each feeding the next), with the CUDA-event time per call beside.

    python3 scripts/roofline_torch.py              # the full table
    python3 scripts/roofline_torch.py fast9 ccl    # rows whose names hold these

Writes build/roofline_torch.md and keeps the rows in
build/roofline_torch_rows.json, where a later partial run merges its rows;
rows taken on another card, or at another power limit, are dropped from
it. Never writes ROOFLINE.md (the reference's TPU table). Without a card it
raises: a roofline from the CPU is not a device number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402

OUT_MD = os.path.join(ROOT, "build", "roofline_torch.md")
CACHE = os.path.join(ROOT, "build", "roofline_torch_rows.json")

# Published peaks at the full 700 W (NVIDIA's data sheet, SXM part, dense):
# memory bytes/s; fp32 outside the tensor cores (an FMA counts two; FP64 on
# the tensor cores has the same rate); int32 on half of the fp32 lanes, one
# operation each; bf16 and int8 on the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "f32": 67e12,
                              "int32": 67e12 / 4, "bf16": 989e12,
                              "int8": 1979e12},
}
FULL_POWER_W = 700.0

ROWS = ("fast9_nms_topk_720p", "bf_hamming_2048x2048x256",
        "histogram256_720p", "hough_sht_accumulate_E64k",
        "ccl_label_1122x1182", "wolf_41x41_720p",
        "ba_step_O100000_F256", "ba_schur_O100000_F256")

# BA at production scale (scripts/roofline.py:181)
F_CAMS, L_LMS, O_OBS = 256, 20000, 100000
E_POINTS, N_THETA = 65536, 180


def roofline_inputs() -> dict:
    """scripts/roofline.py's inputs, as numpy arrays: bench's scene and text
    binary, then from np.random.default_rng(0), in the order of its full
    run, the two (2048, 256) bit matrices, the 65,536 Hough points and the
    BA problem."""
    gray, text = bench_torch._images()
    h, w = gray.shape
    rs = np.random.default_rng(0)
    out = {"gray": gray, "text_bin": (text < 128).astype(np.uint8) * 255}
    out["q"] = rs.integers(0, 2, (2048, 256), np.uint8)
    out["t"] = rs.integers(0, 2, (2048, 256), np.uint8)
    out["x"] = rs.integers(0, w, E_POINTS).astype(np.float32)
    out["y"] = rs.integers(0, h, E_POINTS).astype(np.float32)
    out["cams"] = rs.normal(0, 0.1, (F_CAMS, 6)).astype(np.float32)
    out["lms"] = (rs.normal(0, 1.0, (L_LMS, 3)).astype(np.float32)
                  + np.array([0, 0, 5], np.float32))
    out["ci"] = rs.integers(0, F_CAMS, O_OBS).astype(np.int32)
    out["li"] = rs.integers(0, L_LMS, O_OBS).astype(np.int32)
    out["uv"] = (rs.normal(0, 50, (O_OBS, 2)).astype(np.float32)
                 + np.array([320, 240], np.float32))
    return out


# ---- the models: (bytes, {unit: operations}, what they count)

def fast9_model(h: int, w: int, pairs_brighter: int, pairs_darker: int,
                k: int = 2000):
    n = h * w
    return (n + k * (4 + 8),
            {"int32": 18 * n + 40 * (pairs_brighter + pairs_darker) + n},
            "u8 image in, top-k (f32 value, i64 index) out; per pixel 18 "
            "(opposite-pair tests, combination, NMS as 16-bit pairs), 40 a "
            "pixel pair and side that passes its test (arc minima), 1 "
            "compare for the top-k")


def hamming_model(nq: int, nt: int, bits: int, k: int = 2):
    return (nq * bits + nt * bits + k * nq * (4 + 4 + 1),
            {"int8": 2 * nq * nt * bits, "int32": k * nq * nt},
            "two u8 bit matrices in, (k, Nq) index / distance / valid out; "
            "the distances as one 0/1 product on the int8 tensor cores, "
            "k compares a pair for the top-k")


def histogram_model(n: int):
    return (n + 256 * 4, {"int32": n},
            "u8 image in, 256 i32 counts out; one increment a pixel")


def sht_model(e: int, valid: int, n_theta: int, n_rho: int):
    return (3 * 4 * e + 2 * 4 * n_theta + 4 * n_theta * n_rho,
            {"f32": 7 * valid * n_theta},
            "f32 x, y and i32 weights in, the f32 cos / sin table in, "
            "(n_theta, n_rho) i32 votes out; 7 ops an edge and theta (rho "
            "by FMA, scale, round, vote)")


def ccl_model(n: int):
    return (n + 4 * n, {"int32": 10 * n},
            "u8 binary in, i32 labels out; ~10 ops a pixel (index, "
            "neighbour compares, one find step)")


def wolf_model(n: int):
    return (n + n, {"int32": 11 * n, "f32": 10 * n},
            "u8 image in, u8 binary out; per pixel 11 int32 (square, two "
            "2-pass prefix sums, two box sums) and 10 f32 (mean, variance, "
            "std, its max, the threshold, compare)")


def ba_model(f: int, l: int, o: int, cg: int):
    params = (f * 6 + l * 3) * 4
    return (2 * params + 16 + o * (4 + 4 + 8 + 1),
            {"f32": o * 300 + (cg + 1) * o * 72},
            "cameras, landmarks, intrinsics, observations in, cameras and "
            "landmarks out; linearize ~300 flop an observation, "
            f"{cg + 1} matvecs of J^T J at 72 flop an observation")


def schur_model(f: int, l: int, o: int, sum_k2: int):
    params = (f * 6 + l * 3) * 4
    return (2 * params + 16 + o * (4 + 4 + 8 + 1),
            {"f32": o * 300 + 216 * sum_k2 + (6 * f) ** 3 // 3
             + 2 * (6 * f) ** 2},
            "as ba_step; linearize ~300 flop an observation, S = Hcc - W "
            "Y W^T at 216 flop a pair of one landmark's observations, the "
            "(6F)^3 / 3 Cholesky and two triangular solves")


def bound(nbytes: float, ops: dict, peaks: dict) -> dict:
    """The least time the card could take: the bytes at the memory rate,
    or each unit's operations at its peak, summed, whichever is larger."""
    by_bytes = nbytes / peaks["hbm"] * 1e3
    by_ops = sum(n / peaks[unit] for unit, n in ops.items()) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _pairs(cand: torch.Tensor) -> int:
    """Horizontal pixel pairs of which a pixel is a candidate."""
    cand = torch.nn.functional.pad(cand, (0, cand.shape[1] % 2))
    return int((cand[:, 0::2] | cand[:, 1::2]).sum())


def step_slope(step, state, r1: int, r2: int, trials: int = 3) -> dict:
    """A chain of ``step`` calls, each fed the last one's result and ended
    by reading a value: the median of ``trials`` slopes (T(r2) - T(r1)) /
    (r2 - r1), and the CUDA-event time per step of the r2 chains (None
    off the card)."""
    cuda = state.cameras.is_cuda

    def run(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        s = state
        for _ in range(reps):
            s = step(s)
        if cuda:
            end.record()
        s.cameras[0, 0].item()               # waits for the chain
        return (time.perf_counter() - t0,
                start.elapsed_time(end) / reps if cuda else None)

    run(1)
    slopes, events = [], []
    for _ in range(trials):
        ta = run(r1)[0]
        tb, ev = run(r2)
        slopes.append((tb - ta) / (r2 - r1))
        events.append(ev)
    return {"r1": r1, "r2": r2, "ms": sorted(slopes)[trials // 2] * 1e3,
            "event_ms": sorted(events)[trials // 2] if cuda else None}


def measure(names, dev: torch.device, peaks: dict,
            target: float = 0.4) -> list:
    """The rows whose names hold one of ``names`` (all when empty), each
    as a dict: its model, its bound at ``peaks``, its times on ``dev`` and
    its share. main() takes it on the card only."""
    from compv_tpu_torch.features.ccl import label_components
    from compv_tpu_torch.features.hough_trig import theta_table
    from compv_tpu_torch.image.histogram import histogram256
    from compv_tpu_torch.image.threshold import threshold_wolf
    from compv_tpu_torch.matchers.bruteforce import knn_match
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.topk import select_top_k_2d
    from compv_tpu_torch.slam.ba import BAConfig, BAProblem, ba_step
    from compv_tpu_torch.slam.ba_schur import (SchurConfig, ba_step_schur,
                                               max_obs_per_landmark)

    def want(row):
        return not names or any(k in row for k in names)

    on_cpu = dev.type == "cpu"
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in roofline_inputs().items()}
    gray, text_bin = inp["gray"], inp["text_bin"]
    h, w = gray.shape
    n, nt = gray.numel(), text_bin.numel()
    rows = []

    def launched(call) -> dict:
        """The hand kernels that one call launched, and how often."""
        before = bench_torch.launch_counts()
        call()
        if not on_cpu:
            torch.cuda.synchronize()
        after = bench_torch.launch_counts()
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    def chained(name, fn, arr, model):
        launches = launched(lambda: fn(arr))
        add(name, bench_torch.measure(fn, arr, on_cpu, target), model,
            launches)

    def add(name, timed, model, launches):
        nbytes, ops, what = model
        b = bound(nbytes, ops, peaks)
        rows.append({"name": name, "bytes": nbytes, "ops": ops,
                     "model": what, **b, **timed,
                     "share": b["bound_ms"] / timed["ms"],
                     "launches": launches})

    def sums(vals):
        return vals.to(torch.float32).sum(), vals.sum()

    if want(ROWS[0]):
        brighter, darker = fk.early_out_candidates(gray, 20)

        def fast9(im):
            v, _ = select_top_k_2d(fk.fast_strengths_nms(
                im, 20, 9, nms=True, as_f32=True), 2000)
            return v.sum(), bench_torch._as_i32(v.sum())
        chained(ROWS[0], fast9, gray,
                fast9_model(h, w, _pairs(brighter), _pairs(darker)))

    if want(ROWS[1]):
        def hamming(q):
            m = knn_match(q, inp["t"], k=2)
            d = torch.where(m.valid, m.distance, 0.0).sum()
            return d, bench_torch._as_i32(d)
        chained(ROWS[1], hamming, inp["q"], hamming_model(2048, 2048, 256))

    if want(ROWS[2]):
        chained(ROWS[2], lambda im: sums(histogram256(im)), gray,
                histogram_model(n))

    if want(ROWS[3]):
        rho_max = float(np.hypot(w, h))
        cos_t, sin_t = theta_table(1.0, dev)
        wt = torch.ones(E_POINTS, dtype=torch.int32, device=dev)

        def sht(x):
            return sums(hk.sht_accumulate(x, inp["y"], wt, N_THETA, rho_max,
                                          1.0, cos_t, sin_t))
        chained(ROWS[3], sht, inp["x"],
                sht_model(E_POINTS, E_POINTS, N_THETA,
                          hk.n_rho_bins(rho_max, 1.0)))

    if want(ROWS[4]):
        chained(ROWS[4], lambda im: sums(label_components(im)), text_bin,
                ccl_model(nt))

    if want(ROWS[5]):
        chained(ROWS[5], lambda im: sums(threshold_wolf(im, 41)), gray,
                wolf_model(n))

    if want(ROWS[6]) or want(ROWS[7]):
        prob = BAProblem(inp["cams"], inp["lms"],
                         torch.tensor([500.0, 500.0, 320.0, 240.0],
                                      device=dev),
                         inp["ci"], inp["li"], inp["uv"],
                         torch.ones(O_OBS, dtype=torch.bool, device=dev))
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        if want(ROWS[6]):
            cfg = BAConfig(cg_iterations=20)

            def step(p):
                return ba_step(p, lam, cfg)[0]
            launches = launched(lambda: step(prob))
            add(ROWS[6], step_slope(step, prob, 3, 13),
                ba_model(F_CAMS, L_LMS, O_OBS, cfg.cg_iterations), launches)
            rows[-1]["steps_per_s"] = 1e3 / rows[-1]["ms"]
        if want(ROWS[7]):
            kmax = max_obs_per_landmark(prob.lm_idx, prob.valid, L_LMS)
            per_lm = torch.bincount(prob.lm_idx.long(), minlength=L_LMS)
            scfg = SchurConfig()

            def schur(p):
                return ba_step_schur(p, lam, scfg, max_obs_per_lm=kmax)[0]
            launches = launched(lambda: schur(prob))
            add(ROWS[7], step_slope(schur, prob, 2, 8),
                schur_model(F_CAMS, L_LMS, O_OBS,
                            int((per_lm * per_lm).sum())), launches)
            rows[-1]["steps_per_s"] = 1e3 / rows[-1]["ms"]
    return rows


def merge(cache_path: str, rows: list, device: str, power_w: float) -> list:
    """The cached rows of this card at this power limit, updated by
    ``rows`` (each stamped with both) and written back."""
    merged = {}
    if os.path.exists(cache_path):
        with open(cache_path) as fh:
            loaded = json.load(fh)
        merged = {k: v for k, v in loaded.items()
                  if v.get("device") == device
                  and v.get("power_limit_w") == power_w}
    for r in rows:
        merged[r["name"]] = {**r, "device": device, "power_limit_w": power_w}
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "w") as fh:
        json.dump(merged, fh, indent=1)
    return [merged[k] for k in ROWS if k in merged]


def power_limit_w(card: str) -> float:
    """The watts of ``card``'s line ("NAME, 700.00 W")."""
    return float(card.rsplit(",", 1)[1].strip().split()[0])


def table(rows: list, card: str, peaks: dict) -> list:
    power = power_limit_w(card)
    lines = [
        "# Roofline of the port on the card (scripts/roofline_torch.py)",
        "",
        f"Card: {card}. Peaks (700 W, data sheet): memory "
        f"{peaks['hbm'] / 1e12:.2f} TB/s, f32 {peaks['f32'] / 1e12:.0f} "
        f"TFLOP/s, int32 {peaks['int32'] / 1e12:.2f} TOP/s, bf16 "
        f"{peaks['bf16'] / 1e12:.0f} TFLOP/s, int8 "
        f"{peaks['int8'] / 1e12:.0f} TOP/s.",
        "Shares are against these peaks, not scaled to the card's power "
        "limit" + (f" ({power} W, under {FULL_POWER_W:.0f} W)."
                   if power < FULL_POWER_W else "."),
        "",
        "| row | ms (slope) | event ms | bytes | operations | bound ms "
        "(set by) | share | hand kernels a call | model |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ops = ", ".join(f"{v:.4g} {u}" for u, v in r["ops"].items())
        lines.append(
            f"| {r['name']} | {r['ms']:.6g} | {r['event_ms']:.6g} | "
            f"{r['bytes']} | {ops} | {r['bound_ms']:.6g} ({r['bound_by']}) "
            f"| {100 * r['share']:.4g} % | {r['launches'] or '-'} | "
            f"{r['model']} |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rows", nargs="*",
                    help="substrings of the row names to run (default: all)")
    args = ap.parse_args(argv)
    from compv_tpu_torch.device import require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench_torch.card_line()
    name = torch.cuda.get_device_name(dev)
    if name not in PEAKS:
        raise RuntimeError(f"no peaks known for {name!r}")
    rows = measure(args.rows, dev, PEAKS[name])
    rows = merge(CACHE, rows, name, power_limit_w(card))
    lines = table(rows, card, PEAKS[name])
    print("\n".join(lines), flush=True)
    with open(OUT_MD, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"wrote {os.path.relpath(OUT_MD, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
