"""The port's benchmark suite: bench.py's 29 rows through compv_tpu_torch.

Prints one JSON line per row, as bench.py does,
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": ratio,
   "device": ..., ...}
then the summary line {"metric": "suite_geomean_vs_reference", ...}.
vs_baseline is the row's frames/s over the reference's (CompV's own
published speed_compare figures on an i7-4790K, BASELINE.md), the same
figures and the same two derived baselines as bench.py. "device" is the
card's name and power limit as nvidia-smi gives them, or "cpu".

Method (bench.py's, run eagerly on one CUDA stream): a row's call is chained
R times, each call's input perturbed at element 0 by the previous call's
checksum mod 2, so no call can start before the one it depends on; T(R) is a
host clock around the chain, ended by reading the accumulator with .item(),
which waits for the card. The per-call time is the slope (T(R2) - T(R1)) /
(R2 - R1), which cancels the chain's fixed costs; R2 is sized from a probe
to a differential time of --target-diff seconds (at most 1100 calls), R1 =
R2 // 11, and the median of 3 slopes is kept. The chain makes no host sync
but those its row makes itself (MSER's ladder, Canny's hysteresis). Each
line also gives the CUDA-event time per call of the R2 chains (median), and
the hand kernels' launches in one call of the row with its (accumulator,
checksum). Where no slope came out positive, the line gives the whole R2
chain's time per call and says "method": "whole_call".

    python3 bench_torch.py                      # on the card
    python3 bench_torch.py --metrics a,b        # bench.py's BENCH_METRICS
    python3 bench_torch.py --device cpu         # bench.py's BENCH_CPU=1
    python3 bench_torch.py --once [--device cpu]   # one call a row, untimed

Without a card and without --device cpu it raises: a CPU run is never a
device number. A row that raises prints an error line, the suite goes on,
and the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HEADLINE = "fast9_nms_detect_fps_1282x720"

# The reference's BF-matcher row is 200x258 descriptors; the 2048x2048 row
# uses the same rate in descriptor pairs/s: 200*258*1000 pairs / 0.260 s =
# 198.5M pairs/s -> at 2048*2048 pairs a frame, 47.32 frames/s.
bf_big_ref_fps = (200 * 258 * 1000 / 0.260) / (2048 * 2048)

# The frontend pair's baseline, derived from the reference's own component
# rows: 2 x FAST9 detect (0.3358 ms, speed_compare:73-80) + KNN2 Hamming at
# 2000x2000 pairs scaled linearly from the 200x258 row (198.5M pairs/s,
# speed_compare:135-140) = 20.15 ms -> 48.0 frames/s.
frontend_ref_fps = 1.0 / (2 * 0.3358e-3 + (2000.0 * 2000.0)
                          / (200 * 258 * 1000 / 0.260))

# (row, the reference's frames/s), in bench.py's order
REF_FPS = (
    ("rgb24_to_gray", 10000 / 0.449),
    ("i420_to_rgb24", 10000 / 0.968),
    ("rgb24_to_hsv", 10000 / 2.137),
    ("yuv420p_to_hsv", 10000 / 3.045),
    ("split_rgb", 10000 / 0.694),
    ("histogram_256", 10000 / 1.073),
    ("hist_equalize", 10000 / 2.675),
    ("integral_sq", 1000 / 1.832),
    ("otsu_threshold", 10000 / 1.253),
    ("adaptive_thresh_5x5", 10000 / 3.551),
    ("wolf_binarization_41x41", 1000 / 8.721),
    ("gaussian_blur_7x7", 10000 / 1.367),
    ("sobel3x3", 10000 / 7.476),
    ("scale_bilinear", 10000 / 1.474),
    ("scale_bicubic", 10000 / 6.671),
    ("rotate_45_paeth", 1000 / 1.540),
    (HEADLINE, 10000 / 3.358),
    ("canny3x3", 10000 / 14.903),
    ("morph_erode_3x3", 10000 / 0.449),
    ("morph_close_3x3", 10000 / 0.794),
    ("hough_sht", 1000 / 10.367),
    ("hough_kht", 1000 / 1.413),
    ("hog_8x8_l2hys", 1000 / 5.198),
    ("bf_hamming_knn2_200x258", 1000 / 0.260),
    ("bf_hamming_knn2_2048x2048", bf_big_ref_fps),
    ("ccl_label_text", 10000 / 2.973),
    ("ccl_boxes_text", 10000 / 0.956),
    ("frontend_pair_720p", frontend_ref_fps),
    ("mser_text", 1000 / 27.072),
)


def _images():
    """bench.py's two scenes, drawn from np.random.default_rng(0): the
    720x1282 gray scene (gradient, a checkerboard patch for FAST / ORB,
    noise) and the 1122-wide, 1182-tall text scan of the CCL / MSER rows
    (glyph rows, antialias, sensor noise)."""
    h, w = 720, 1282
    rs = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > 300) & (xx < 1000) & (yy > 150) & (yy < 570),
                    ch * 200.0 + 20, base)
    gray = np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)

    th, tw = 1182, 1122
    text = np.full((th, tw), 235, np.uint8)
    # glyph-like dark blobs: ~90 lines of ~40 "characters" of random strokes
    for row in range(20, th - 14, 13):
        for col in range(16, tw - 10, 28):
            if rs.random() < 0.15:
                continue
            gw = min(int(rs.integers(12, 22)), tw - 10 - col)
            gh = min(int(rs.integers(7, 10)), th - 14 - row)
            glyph = rs.random((gh, gw)) < 0.45
            # thicken horizontally so strokes connect like type
            glyph[:, 1:] |= glyph[:, :-1]
            text[row:row + gh, col:col + gw][glyph] = 20
    # a scan: antialias + sensor noise
    from scipy import ndimage as _ndi
    text = np.clip(_ndi.gaussian_filter(text.astype(np.float32), 0.8)
                   + rs.normal(0, 3.0, text.shape), 0, 255).astype(np.uint8)
    return gray, text


def inputs(gray: np.ndarray, text: np.ndarray) -> dict:
    """bench.py's row inputs (its lines 109-125) as numpy arrays: the
    scene, the text scan and its binary, the scene's rolled RGB, the seeded
    I420 chroma, the 200x256, 258x256 and two 2048x256 bit matrices and the
    1285x1285 binary, drawn from np.random.default_rng(1) in bench.py's
    order."""
    h, w = gray.shape
    rs = np.random.default_rng(1)
    out = {"gray": gray, "text": text,
           "text_bin": (text < 128).astype(np.uint8) * 255,
           "rgb": np.stack([gray, np.roll(gray, 3, 0), np.roll(gray, 7, 1)],
                           -1)}
    out["u_p"] = rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8)
    out["v_p"] = rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8)
    for name, shape in (("descq", (200, 256)), ("desct", (258, 256)),
                        ("descq_big", (2048, 256)),
                        ("desct_big", (2048, 256))):
        out[name] = rs.integers(0, 2, shape, dtype=np.uint8)
    out["big_bin"] = rs.integers(0, 2, (1285, 1285), dtype=np.uint8) * 255
    return out


def _i32(v: torch.Tensor) -> torch.Tensor:
    """An int64 sum as the int32 that XLA's int32 sum wraps to."""
    return (v.to(torch.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _as_i32(a: torch.Tensor) -> torch.Tensor:
    """``a.astype(int32)`` as XLA converts (floats truncated toward zero,
    saturated, NaN to 0), held in int64."""
    if a.is_floating_point():
        a = torch.nan_to_num(a.to(torch.float64).trunc(), nan=0.0)
        a = a.clamp(-2 ** 31, 2 ** 31 - 1)
    return a.to(torch.int64)


def u8sum(a):
    v = _i32(_as_i32(a).sum())
    return v.to(torch.float32), v


def fsum(a):
    return (a.to(torch.float32).sum(),
            torch.ones((), dtype=torch.int32, device=a.device))


def match_sum(m):
    return (torch.where(m.valid, m.distance, 0.0).sum(),
            _i32(m.train_idx.to(torch.int64).sum()))


def lines_sum(lines):
    return lines.strength.sum(), _i32(_as_i32(lines.rho.sum()))


def rows(inp: dict) -> list:
    """bench.py's cases through the port, in its order: (name, the input a
    chain perturbs, fn(input) -> (f32 accumulator, integer checksum), the
    reference's frames/s). ``inp`` holds inputs()'s arrays as tensors on
    one device. The input of ccl_boxes_text (the text binary's labels) is
    a function, labelled when the row is taken."""
    from compv_tpu_torch.calib.homography import find_homography
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.ccl import (CclConfig,
                                              ccl_features_from_labels,
                                              label_components)
    from compv_tpu_torch.features.edges import edge_detect, sobel_gradients
    from compv_tpu_torch.features.hog import HogConfig, hog_descriptor
    from compv_tpu_torch.features.hough import (HoughKhtConfig,
                                                HoughShtConfig, hough_kht,
                                                hough_sht)
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu_torch.image.color import (_upsample2, i420_to_rgb,
                                             rgb_to_gray, rgb_to_hsv,
                                             split_channels, yuv444_to_hsv)
    from compv_tpu_torch.image.histogram import equalize, histogram256
    from compv_tpu_torch.image.integral import integral, integral_squared
    from compv_tpu_torch.image.morph import close_, erode, strel
    from compv_tpu_torch.image.scale import rotate_fast, scale
    from compv_tpu_torch.image.threshold import (threshold_adaptive,
                                                 threshold_otsu,
                                                 threshold_wolf)
    from compv_tpu_torch.matchers.bruteforce import knn_match
    from compv_tpu_torch.ops.conv import gaussian_blur
    from compv_tpu_torch.ops.kernels.fast_kernel import fast_strengths_nms
    from compv_tpu_torch.ops.topk import select_top_k_2d

    gray, rgb, text = inp["gray"], inp["rgb"], inp["text"]
    u_p, v_p, text_bin = inp["u_p"], inp["v_p"], inp["text_bin"]
    h, w = gray.shape
    se3 = strel("cross", 3)
    # made once: a tensor made from a number in the chain would copy it to
    # the card, and wait, every call
    angle = torch.tensor(44.9, dtype=torch.float32, device=gray.device)

    def fast9(im):
        # K1 on the card: strengths and strict NMS in one launch
        vals, idx = select_top_k_2d(
            fast_strengths_nms(im, 20, 9, nms=True, as_f32=True), 2000)
        return vals.sum(), _i32(idx.sum())

    def frontend_pair(im):
        im2 = torch.roll(im, (4, 7), (0, 1))
        cfg_orb = OrbConfig(max_features=2000)
        kp1, d1 = orb_detect_describe(im, cfg_orb)
        kp2, d2 = orb_detect_describe(im2, cfg_orb)
        m = knn_match(d1, d2, k=2)
        q = torch.stack([kp1.x, kp1.y], 1)
        t = torch.stack([kp2.x, kp2.y], 1)[m.train_idx[0].to(torch.int64)]
        res = find_homography(q, t, mask=m.valid[0] & kp1.valid)
        return (torch.where(torch.isfinite(res.h), res.h, 0.0).sum(),
                _i32(res.inliers.sum()))

    def ccl_boxes(lb):
        r = ccl_features_from_labels(lb, CclConfig())
        return r.area.sum().to(torch.float32), _i32(r.box_x1.sum())

    def mser(im):
        r = mser_detect(im, MserConfig())
        return r.area.sum().to(torch.float32), _i32(r.level.sum())

    def kht(im):
        gx, gy = sobel_gradients(im)
        return lines_sum(hough_kht(canny(im, CannyConfig()), gx, gy,
                                   HoughKhtConfig()))

    fns = {
        "rgb24_to_gray": (rgb, lambda im: u8sum(rgb_to_gray(im))),
        "i420_to_rgb24": (gray, lambda im: u8sum(i420_to_rgb(im, u_p, v_p))),
        "rgb24_to_hsv": (rgb, lambda im: u8sum(rgb_to_hsv(im))),
        # chroma upsample + fused YUV -> RGB -> HSV
        "yuv420p_to_hsv": (gray, lambda im: u8sum(yuv444_to_hsv(
            im, _upsample2(u_p, h, w), _upsample2(v_p, h, w)))),
        "split_rgb": (rgb, lambda im: u8sum(split_channels(im)[0])),
        "histogram_256": (gray, lambda im: u8sum(histogram256(im))),
        "hist_equalize": (gray, lambda im: u8sum(equalize(im))),
        "integral_sq": (gray, lambda im: u8sum(
            integral(im, torch.float32)[-1, -1:]
            + integral_squared(im, torch.float32)[-1, -1:])),
        "otsu_threshold": (gray, lambda im: u8sum(threshold_otsu(im)[0])),
        "adaptive_thresh_5x5": (gray, lambda im: u8sum(
            threshold_adaptive(im, 5, 21))),
        "wolf_binarization_41x41": (gray, lambda im: u8sum(
            threshold_wolf(im, 41))),
        "gaussian_blur_7x7": (gray, lambda im: u8sum(
            gaussian_blur(im, 7, 2.0))),
        "sobel3x3": (gray, lambda im: u8sum(edge_detect(im, "sobel"))),
        "scale_bilinear": (gray, lambda im: u8sum(
            scale(im, 597, 1064, "bilinear"))),
        # the reference is slower than OpenCV here: its baseline is
        # OpenCV's 6671 ms / 10k, the best published number of the table
        "scale_bicubic": (gray, lambda im: u8sum(
            scale(im, 597, 1064, "bicubic"))),
        "rotate_45_paeth": (gray, lambda im: u8sum(rotate_fast(im, angle))),
        HEADLINE: (gray, fast9),
        "canny3x3": (gray, lambda im: u8sum(canny(im, CannyConfig()))),
        "morph_erode_3x3": (inp["big_bin"], lambda im: u8sum(erode(im, se3))),
        "morph_close_3x3": (inp["big_bin"], lambda im: u8sum(
            close_(im, se3))),
        "hough_sht": (gray, lambda im: lines_sum(hough_sht(
            canny(im, CannyConfig()), HoughShtConfig()))),
        "hough_kht": (gray, kht),
        # 8x8 cells, 9 bins, L2-Hys
        "hog_8x8_l2hys": (gray, lambda im: fsum(hog_descriptor(
            im, HogConfig(norm="l2hys")))),
        "bf_hamming_knn2_200x258": (inp["descq"], lambda q: match_sum(
            knn_match(q, inp["desct"], k=2))),
        "bf_hamming_knn2_2048x2048": (inp["descq_big"], lambda q: match_sum(
            knn_match(q, inp["desct_big"], k=2))),
        "ccl_label_text": (text_bin, lambda im: u8sum(label_components(im))),
        # features from an existing labelling, as the reference measures
        # extraction apart from labelling (speed_compare:181-186)
        "ccl_boxes_text": (lambda: label_components(text_bin), ccl_boxes),
        "frontend_pair_720p": (gray, frontend_pair),
        "mser_text": (text, mser),
    }
    return [(name, *fns[name], ref) for name, ref in REF_FPS]


# profiling.hand_kernel_launches()'s keys (the device kernels' names) as
# the kernels' ids
KERNEL_IDS = {"fast_kernel": "K1", "label_tiles": "K2a",
              "merge_seeded": "K2b", "compact": "K3",
              "sht_accumulate": "K4", "strip_counts": "K5",
              "orb_orient": "K6", "level_areas": "K7"}


def launch_counts() -> dict:
    """The hand kernels' launch counters, by id (K1-K5, K6 for ORB's
    orientation kernel and K7 for MSER's ladder level areas)."""
    from compv_tpu_torch.profiling import hand_kernel_launches

    return {KERNEL_IDS[k]: n for k, n in hand_kernel_launches().items()}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def chain(fn, arr: torch.Tensor, reps: int):
    """One dependent chain of ``reps`` calls of ``fn`` from ``arr``: (host
    seconds, CUDA-event ms on the card or None, the accumulator)."""
    cur = arr.clone(memory_format=torch.contiguous_format)
    first = cur.view(-1)[:1]
    acc = torch.zeros((), dtype=torch.float32, device=arr.device)
    events = None
    if arr.is_cuda:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    if events:
        events[0].record()
    for _ in range(reps):
        sv, si = fn(cur)
        acc = acc + sv
        first += (si % 2).to(cur.dtype)
    if events:
        events[1].record()
    total = acc.item()                     # waits for the chain
    seconds = time.perf_counter() - t0
    return seconds, events and events[0].elapsed_time(events[1]), total


def measure(fn, arr: torch.Tensor, on_cpu: bool, target_diff: float) -> dict:
    """bench.py's slope: R2 sized from a 17-call probe, R1 = R2 // 11, the
    median of 3 slopes (one trial of R1 = 1, R2 = 3 on the CPU)."""
    if on_cpu:
        r1, r2, trials = 1, 3, 1
    else:
        t_one = chain(fn, arr, 1)[0]
        probe = 17
        t_probe = chain(fn, arr, probe)[0]
        est = max((t_probe - t_one) / (probe - 1), 1e-7)
        r2 = int(np.clip(round(target_diff / est), 3, 1100))
        r1 = max(1, r2 // 11)
        trials = 3
    slopes, event_ms = [], []
    for _ in range(trials):
        ta = chain(fn, arr, r1)[0]
        tb, ev, _ = chain(fn, arr, r2)
        if ev is not None:
            event_ms.append(ev / r2)
        s = (tb - ta) / (r2 - r1)
        if s > 0:
            slopes.append(s)
    out = {"r1": r1, "r2": r2}
    if not slopes:
        # a fast row drowned in noise at tiny reps: the whole chain's time
        # per call, an upper bound, never silent
        tb, ev, _ = chain(fn, arr, r2)
        slopes = [tb / r2]
        out["method"] = "whole_call"
    out["ms"] = sorted(slopes)[len(slopes) // 2] * 1e3
    out["event_ms"] = sorted(event_ms)[len(event_ms) // 2] if event_ms \
        else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: tiny reps, every line says \"cpu\"")
    ap.add_argument("--metrics", default=None,
                    help="comma-separated rows to run (default: all 29)")
    ap.add_argument("--target-diff", type=float, default=0.5,
                    help="differential time of a trial's chains, seconds")
    ap.add_argument("--once", action="store_true",
                    help="one call a row: its (acc, checksum) and launches, "
                         "no timing and no summary line")
    args = ap.parse_args(argv)
    only = set(args.metrics.split(",")) if args.metrics else None
    on_cpu = args.device == "cpu"
    if on_cpu:
        dev, device = torch.device("cpu"), "cpu"
    else:
        from compv_tpu_torch.device import require_cuda

        dev = require_cuda()
        device = card_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if only is not None:
        unknown = only - {name for name, _ in REF_FPS}
        if unknown:
            raise ValueError(f"no such rows: {sorted(unknown)}")

    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in inputs(*_images()).items()}
    results, failed = {}, False
    for name, arr, fn, ref_fps in rows(inp):
        if only is not None and name not in only:
            continue
        try:
            if callable(arr):
                arr = arr()
            # warm-up: one call, its launches and its (acc, checksum)
            before = launch_counts()
            sv, si = fn(arr)
            acc, checksum = float(sv), int(si)
            after = launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            if args.once:
                print(json.dumps({"metric": name, "device": device,
                                  "launches": launches, "acc": acc,
                                  "checksum": checksum}), flush=True)
                continue
            timed = measure(fn, arr, on_cpu, args.target_diff)
            fps = 1e3 / timed["ms"]
            results[name] = (fps, ref_fps)
            print(json.dumps({"metric": name, "value": round(fps, 2),
                              "unit": "frames/s",
                              "vs_baseline": round(fps / ref_fps, 3),
                              "device": device, **timed,
                              "launches": launches, "acc": acc,
                              "checksum": checksum}), flush=True)
        except Exception as e:  # noqa: BLE001 — report, go on, exit 1
            failed = True
            print(json.dumps({"metric": name, "error": str(e)[:200],
                              "device": device}), flush=True)

    if results:
        geo = float(np.exp(np.mean([np.log(f / r)
                                    for f, r in results.values()])))
        line = {"metric": "suite_geomean_vs_reference",
                "value": round(geo, 3), "unit": "x",
                "vs_baseline": round(geo, 3), "n_metrics": len(results),
                "device": device}
        if HEADLINE in results:
            f, r = results[HEADLINE]
            line["headline_fast9_fps"] = round(f, 1)
            line["headline_vs_baseline"] = round(f / r, 3)
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
