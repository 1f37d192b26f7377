"""Smoke test of the PyTorch / CUDA port (compv_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. device and build: the card's name and power limit, the five kernel
     sources built in parallel (one nvcc each), their ptxas lines;
  2. kernel vs twin: the FAST kernel K1 against its plain PyTorch twin, by
     exact equality, on the 720p scene and its pyramid and on odd sizes;
  3. goldens on the card: goldens/goldens.json's FAST tuples, homography,
     md5, Otsu, CCL-features and MSER values, computed by the port on the GPU;
  4. the ORB slice: slam.frontend.match_pair on a 720x1282 scene paired
     with its roll by (4, 7), at the full ORB/RANSAC configuration, with the
     kernel's launch count, geometric and determinism checks, and the same
     pair through the kernel's twins;
  5. times of the ORB slice: match_pair and the two-output K1 launch against
     its twin, as medians of CUDA-event timings;
  6. CCL kernels vs twins: the labeler K2a / K2b and the row compactor K3
     against their twins, exact, on bench.py's 1122x1182 text scene (its
     binary at both connectivities, every level of its MSER ladder, its run
     tables with and without overflow), a 1285x1285 random binary, a snake
     and edge shapes; the text partition against scipy.ndimage.label;
  7. the text-blob slice: features.ccl.ccl_features on the text binary and
     features.mser.mser_detect on the text scene at full width, with launch
     counts, scipy's component count, determinism, and the same calls
     through the twins;
  8. times of the text-blob slice (bench.py's ccl_label_text,
     ccl_boxes_text and mser_text rows) and of K2a, K2b and K3 against
     their twins, as medians of CUDA-event timings;
  9. Hough kernels vs twins: the SHT accumulator K4 against its twin,
     exact, on the 720p scene's Canny edge list at 1 and 0.5 degree, a
     dense random map, an empty list and a 2160x3840 map; the strip label
     counter K5 against its twin, exact, on the text binary's labels and
     every changed level of the MSER ladder, and on a truncating case; K5's
     merged counts against torch.bincount and CclResult.area;
 10. the Hough slice: features.canny + features.hough.hough_sht and
     hough_kht on the 720p scene, calib.checkerboard.find_chessboard_corners
     on a rendered 6x8 board 720 rows tall at 12 degrees, with K4's launch
     count, determinism, the twin path, the CPU result and the board's
     truth; K5's own path (the per-strip histograms of every ladder level);
 11. times of the Hough slice (bench.py's canny3x3, hough_sht and
     hough_kht rows, find_chessboard_corners) and of K4 and K5 against
     their twins, as medians of CUDA-event timings.

The scenes come from bench.py's _images(), loaded by path (its module level
imports numpy only). Any failed check raises, and the script exits
non-zero; so it does without a GPU, and outside a checkout of the
repository. The line before the last names the card and its power limit;
the last line of standard output is one JSON object:
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# (name in the kernels line, source, the Pallas function it replaces)
KERNELS = {
    "K1": ("fast_strengths_nms", "compv_tpu_torch/csrc/fast_kernel.cu",
           "compv_tpu/ops/pallas/fast_kernel.py:129"),
    "K2a": ("ccl_label", "compv_tpu_torch/csrc/ccl_kernel.cu",
            "compv_tpu/ops/pallas/ccl_kernel.py:149"),
    "K2b": ("ccl_label_seeded", "compv_tpu_torch/csrc/ccl_kernel.cu",
            "compv_tpu/ops/pallas/ccl_kernel.py:171"),
    "K3": ("compact_rows", "compv_tpu_torch/csrc/compact_kernel.cu",
           "compv_tpu/ops/pallas/compact_kernel.py:47"),
    "K4": ("sht_accumulate", "compv_tpu_torch/csrc/hough_kernel.cu",
           "compv_tpu/ops/pallas/hough_kernel.py:74"),
    "K5": ("strip_label_counts", "compv_tpu_torch/csrc/label_stats.cu",
           "compv_tpu/ops/pallas/label_stats.py:58"),
}


class CheckFailed(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` CUDA-event timings of ``inner`` back-to-back
    calls of ``fn``, in ms per call (after two warm-up calls)."""
    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def load_by_path(name: str, rel: str):
    """A numpy-only module of this checkout (tests/fixtures.py, bench.py),
    loaded by path: a package named ``tests`` elsewhere on sys.path would
    shadow it."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_fixtures():
    return load_by_path("compv_fixtures", os.path.join("tests", "fixtures.py"))


def scenes():
    """bench.py's two scenes: the 720x1282 gray scene of frontend_pair_720p
    (gradient, checkerboard patch, noise, seed 0) and the 1122-wide,
    1182-tall text scene of ccl_label_text / ccl_boxes_text / mser_text
    (glyph rows, antialias, sensor noise; its generator continues after
    the 720p scene's noise)."""
    return load_by_path("compv_bench", "bench.py")._images()


def phase1_device_and_build():
    from compv_tpu_torch.device import require_cuda
    from compv_tpu_torch.ops.kernels import (_build, ccl_kernel,
                                             compact_kernel, fast_kernel,
                                             hough_kernel, label_stats)

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit(card)
    names = ("fast_kernel", "ccl_kernel", "compact_kernel", "hough_kernel",
             "label_stats")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(_build.build, names)))
    for module in (fast_kernel, ccl_kernel, compact_kernel, hough_kernel,
                   label_stats):
        module._kernel_lib()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in path.with_suffix(".log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name, path in paths.items()}
    emit({"phase": 1, "device": torch.cuda.get_device_name(dev), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3),
          "libraries": [p.name for p in paths.values()], "ptxas": ptxas})
    return dev, card


def kernel_vs_twin(img: torch.Tensor, threshold: int, n: int) -> float:
    """Every entry and output type of K1 against the twin on one image;
    raises on any difference, returns the max |difference| (0.0)."""
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    raw = fk._strengths_ref(img, threshold, n)
    sup = fk._nms_ref(raw)
    err = 0.0
    pairs = []
    for nms in (False, True):
        want = sup if nms else raw
        pairs.append((fk.fast_strengths_nms(img, threshold, n, nms, True), want))
        pairs.append((fk.fast_strengths_nms(img, threshold, n, nms, False),
                      want.to(torch.uint8)))
    pairs.extend(zip(fk.fast_strengths_and_nms(img, threshold, n), (raw, sup)))
    for got, want in pairs:
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"K1 output {got.dtype}{tuple(got.shape)} vs twin "
              f"{want.dtype}{tuple(want.shape)}")
        diff = (got.to(torch.float32) - want.to(torch.float32)).abs().max()
        err = max(err, float(diff))
        check(torch.equal(got, want),
              f"K1 != twin at {tuple(img.shape)} t={threshold} n={n}: "
              f"max |diff| {float(diff)}")
    return err


def phase2_kernel_vs_twin(dev, scene: np.ndarray) -> float:
    from compv_tpu_torch.image.pyramid import pyramid_sizes
    from compv_tpu_torch.image.scale import scale_bilinear

    img = torch.from_numpy(scene).to(dev)
    images = [img] + [scale_bilinear(img, lh, lw)
                      for lh, lw in pyramid_sizes(720, 1282, 8, 0.83)[1:]]
    rs = np.random.default_rng(1)
    for shape in ((1, 1), (7, 7), (33, 47), (299, 401)):
        images.append(torch.from_numpy(
            rs.integers(0, 256, shape, dtype=np.uint8)).to(dev))
    err = 0.0
    cases = 0
    for im in images:
        for threshold in (20, 40):
            for n in (9, 12):
                err = max(err, kernel_vs_twin(im, threshold, n))
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": 2, "kernel_vs_twin": "exact", "images": len(images),
          "cases": cases, "max_abs_err": err})
    return err


def phase3_goldens(dev) -> None:
    from compv_tpu_torch.calib.homography import HomographyConfig, find_homography
    from compv_tpu_torch.features.fast import FastConfig, fast_detect
    from compv_tpu_torch.image.color import rgb_to_gray
    from compv_tpu_torch.image.scale import scale_bilinear
    fixtures = load_fixtures()
    make_test_image, make_test_rgb = fixtures.make_test_image, fixtures.make_test_rgb

    with open(os.path.join(ROOT, "goldens", "goldens.json")) as f:
        goldens = json.load(f)
    gray = torch.from_numpy(make_test_image()).to(dev)
    for n, thr, nms in ((9, 20, True), (9, 20, False), (12, 40, True),
                        (9, 40, True)):
        kp = fast_detect(gray, FastConfig(threshold=thr, n=n, nms=nms,
                                          max_features=8192))
        v = kp.valid.cpu().numpy()
        summary = {"count": int(v.sum()),
                   "sum_strength": float(kp.strength.cpu().numpy()[v].sum()),
                   "sum_x": float(kp.x.cpu().numpy()[v].sum()),
                   "sum_y": float(kp.y.cpu().numpy()[v].sum())}
        key = f"fast{n}_thr{thr}_nms{int(nms)}"
        check(summary == goldens[key], f"{key}: {summary} != {goldens[key]}")

    def md5(t):
        return hashlib.md5(np.ascontiguousarray(t.cpu().numpy()).tobytes()
                           ).hexdigest()

    rgb = torch.from_numpy(make_test_rgb()).to(dev)
    check(md5(rgb_to_gray(rgb)) == goldens["md5_to_gray"], "md5_to_gray")
    check(md5(scale_bilinear(gray, 299, 401))
          == goldens["md5_scale_bilinear_299x401"], "md5_scale_bilinear_299x401")

    # the correspondence set of scripts/make_goldens.py:70-79
    rs = np.random.default_rng(11)
    src = rs.uniform(20, 400, (200, 2)).astype(np.float32)
    h_true = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0],
                       [1e-4, -8e-5, 1.0]], np.float32)
    p = np.concatenate([src, np.ones((200, 1), np.float32)], 1) @ h_true.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    dst[150:] += rs.uniform(40, 90, (50, 2)).astype(np.float32)
    res = find_homography(torch.from_numpy(src).to(dev),
                          torch.from_numpy(dst).to(dev),
                          torch.ones(200, dtype=torch.bool, device=dev),
                          HomographyConfig(num_hypotheses=256))
    inliers = int(res.num_inliers)
    check(inliers == goldens["homography_inliers"],
          f"homography_inliers {inliers} != {goldens['homography_inliers']}")
    hm = res.h.cpu().numpy()
    q = np.round((hm / hm[2, 2]).astype(np.float64), 2) + 0.0
    check(hashlib.md5(q.tobytes()).hexdigest() == goldens["homography_hash_q2"],
          f"homography_hash_q2 of {hm.tolist()}")

    # the text-blob goldens of scripts/make_goldens.py:92-101
    from compv_tpu_torch.core.golden import ccl_summary, mser_summary
    from compv_tpu_torch.features.ccl import CclConfig, ccl_features
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.image.threshold import otsu_value, threshold_otsu

    otsu = int(otsu_value(gray))
    check(otsu == goldens["otsu_value"], f"otsu_value {otsu}")
    ccl = ccl_summary(ccl_features(threshold_otsu(gray)[0],
                                   CclConfig(max_components=2048)))
    check(ccl == goldens["ccl_features_summary"], f"ccl_features_summary {ccl}")
    mser = mser_summary(mser_detect(gray[:160, :224].contiguous(),
                                    MserConfig(max_regions=64)))
    check(mser == goldens["mser_summary"], f"mser_summary {mser}")

    # the Hough golden of scripts/make_goldens.py:89-97
    from compv_tpu_torch.core.golden import lines_summary
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.hough import HoughShtConfig, hough_sht

    hough = lines_summary(hough_sht(canny(gray, CannyConfig()),
                                    HoughShtConfig()))
    check(hough == goldens["hough_sht_summary"], f"hough_sht_summary {hough}")
    emit({"phase": 3, "goldens": "met", "checked": [
        "fast9_thr20_nms1", "fast9_thr20_nms0", "fast12_thr40_nms1",
        "fast9_thr40_nms1", "md5_to_gray", "md5_scale_bilinear_299x401",
        "homography_inliers", "homography_hash_q2", "otsu_value",
        "ccl_features_summary", "mser_summary", "hough_sht_summary"]})


@contextlib.contextmanager
def fast_twins():
    """Route the ORB level loop through K1's plain twins (this phase only)."""
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    saved = fk.fast_strengths_and_nms, fk.fast_strengths_nms

    def both(img, threshold=20, n=9):
        s = fk._strengths_ref(img, threshold, n)
        return s, fk._nms_ref(s)

    def one(img, threshold=20, n=9, nms=True, as_f32=False):
        s = fk._strengths_ref(img, threshold, n)
        s = fk._nms_ref(s) if nms else s
        return s if as_f32 else s.to(torch.uint8)

    fk.fast_strengths_and_nms, fk.fast_strengths_nms = both, one
    try:
        yield
    finally:
        fk.fast_strengths_and_nms, fk.fast_strengths_nms = saved


def phase4_slice(dev, scene: np.ndarray):
    from compv_tpu_torch.features.orb import (PATCH_DIAMETER, OrbConfig,
                                              orb_detect_describe)
    from compv_tpu_torch.calib.homography import HomographyConfig
    from compv_tpu_torch.image.pyramid import pyramid_sizes
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.slam.frontend import FrontendConfig, match_pair

    cfg = FrontendConfig(orb=OrbConfig(max_features=2000, levels=8),
                         homography=HomographyConfig())
    img1 = torch.from_numpy(scene).to(dev)
    img2 = torch.roll(img1, (4, 7), (0, 1))
    levels_used = sum(1 for lh, lw in pyramid_sizes(720, 1282, 8, 0.83)
                      if lh >= PATCH_DIAMETER + 2 and lw >= PATCH_DIAMETER + 2)

    torch.cuda.synchronize()
    fk.launches = 0
    res = match_pair(img1, img2, cfg)
    torch.cuda.synchronize()
    launches = fk.launches
    check(launches == 2 * levels_used,
          f"K1 launches {launches} != 2 images x {levels_used} levels")

    num_matches = int(res.num_matches)
    num_inliers = int(res.num_inliers)
    check(num_matches > 100, f"num_matches {num_matches} <= 100")
    check(num_inliers >= 0.5 * num_matches,
          f"num_inliers {num_inliers} < half of {num_matches} matches")
    h = res.h.double().cpu().numpy()
    check(np.isfinite(h).all(), "H not finite")
    gy, gx = np.mgrid[100:621:40, 100:1181:60].astype(np.float64)
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])
    q = h @ p
    moved = q[:2] / q[2]
    err_px = float(np.abs(moved - (p[:2] + np.array([[7.0], [4.0]]))).max())
    check(err_px <= 1.0, f"H misses the (7, 4) shift by {err_px} px")

    again = match_pair(img1, img2, cfg)
    for name in res._fields:
        check(torch.equal(getattr(res, name), getattr(again, name)),
              f"second run differs in {name}")

    with fast_twins():
        twin = [orb_detect_describe(im, cfg.orb) for im in (img1, img2)]
    for im, ref in zip((img1, img2), twin):
        got = orb_detect_describe(im, cfg.orb)
        for name in got.keypoints._fields:
            check(torch.equal(getattr(got.keypoints, name),
                              getattr(ref.keypoints, name)),
                  f"kernel vs twin keypoints differ in {name}")
        check(torch.equal(got.descriptors, ref.descriptors),
              "kernel vs twin descriptors differ")
    emit({"phase": 4, "match_pair": "ok", "kp1_count": int(res.kp1_count),
          "kp2_count": int(res.kp2_count), "num_matches": num_matches,
          "num_inliers": num_inliers, "shift_err_px": err_px,
          "k1_launches": launches, "levels_used": levels_used,
          "twin_path": "identical keypoints and descriptors"})
    return cfg, img1, img2, launches


def phase5_times(dev, card: str, cfg, img1, img2):
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.slam.frontend import match_pair

    pair_ms = cuda_ms(lambda: match_pair(img1, img2, cfg), reps=20)
    kernel_ms = cuda_ms(lambda: fk.fast_strengths_and_nms(img1, 20, 9),
                        reps=20, inner=50)

    def twin():
        s = fk._strengths_ref(img1, 20, 9)
        return s, fk._nms_ref(s)

    twin_ms = cuda_ms(twin, reps=20, inner=5)
    emit({"phase": 5, "card": card, "match_pair_720p_ms": pair_ms,
          "k1_two_output_level0_us": kernel_ms * 1e3,
          "k1_twin_level0_us": twin_ms * 1e3, "timing": "median of 20 "
          "CUDA-event timings after warm-up"})
    return kernel_ms, twin_ms


# ---------------------------------------------------------------------------
# the text-blob path: CCL labeler K2a / K2b, row compactor K3


def oracle_labels(binary: np.ndarray, connectivity: int) -> np.ndarray:
    """Min-flat-index labels from scipy.ndimage.label's partition."""
    from scipy import ndimage

    structure = np.ones((3, 3)) if connectivity == 8 else None
    lab, n = ndimage.label(binary > 0, structure=structure)
    out = np.full(binary.shape, -1, np.int32)
    if n:
        flat = np.arange(binary.size).reshape(binary.shape)
        mins = np.asarray(ndimage.minimum(flat, lab, np.arange(1, n + 1)))
        out[lab > 0] = mins.astype(np.int32)[lab[lab > 0] - 1]
    return out


def ladder(f: torch.Tensor, config):
    """The (fg, init) pairs MSER's ladder gives K2b on ``f`` (dark mode):
    one per changed level, each seeded by the previous level's labels as
    the twin gives them."""
    from compv_tpu_torch.features.mser import ladder_levels
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck

    levels = ladder_levels(config)[2]
    h, w = f.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=f.device).reshape(h, w)
    lbl = torch.full((h, w), -1, dtype=torch.int32, device=f.device)
    pairs = []
    for t in levels:
        fg = f <= t
        if bool((fg != (lbl >= 0)).any()):
            init = torch.where(lbl >= 0, lbl, idx)
            pairs.append((fg, init))
            lbl = ck.label_ref(fg, init, 8)
    return pairs


def run_tables(labels: torch.Tensor, k: int):
    """(packed keys as i32, values, counts) as ccl_features_from_labels
    hands them to K3."""
    from compv_tpu_torch.features.ccl import run_records

    keyu, val, counts = run_records(labels, k)
    return keyu.to(torch.int32), val, counts


def phase6_ccl_kernels_vs_twins(dev, text: np.ndarray):
    from compv_tpu_torch.features.mser import MserConfig
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    rs = np.random.default_rng(5)
    text_bin = (text < 128).astype(np.uint8) * 255
    snake = np.zeros((64, 200), np.uint8)
    for r in range(0, 64, 4):
        snake[r, :] = 1
        if r + 4 < 64:
            snake[r:r + 4, 199 if (r // 4) % 2 == 0 else 0] = 1
    binaries = {
        "text": text_bin,
        "random_1285": rs.integers(0, 2, (1285, 1285), dtype=np.uint8) * 255,
        "snake": snake, "all_bg": np.zeros((301, 257), np.uint8),
        "all_fg": np.ones((301, 257), np.uint8), "1x1_fg": np.ones((1, 1),
                                                                  np.uint8),
        "1x1_bg": np.zeros((1, 1), np.uint8),
        "1xN": (rs.random((1, 1122)) < 0.5).astype(np.uint8),
        "Nx1": (rs.random((1182, 1)) < 0.5).astype(np.uint8),
    }
    cases = 0
    for name, b in binaries.items():
        t = torch.from_numpy(b).to(dev)
        idx = torch.arange(b.size, dtype=torch.int32,
                           device=dev).reshape(b.shape)
        for conn in (4, 8):
            # rounds enough for the twin's pointer stage on percolating
            # random binaries; the kernel needs no such bound
            want = ck.label_ref(t != 0, idx, conn, 1000)
            got = ck.ccl_label(t, conn)
            check(torch.equal(got, want), f"K2a != twin on {name}, "
                  f"connectivity {conn}")
            cases += 1
    got = ck.ccl_label(torch.from_numpy(text_bin).to(dev), 8)
    part = np.array_equal(got.cpu().numpy(), oracle_labels(text_bin, 8))
    check(part, "K2a's text partition != scipy.ndimage.label's")

    f = torch.from_numpy(text).to(dev)
    pairs = ladder(f, MserConfig())
    for fg, init in pairs:
        want = ck.label_ref(fg, init, 8)
        check(torch.equal(ck.ccl_label_seeded(fg, init, 8), want),
              "K2b != twin on a level of the text ladder")

    labels = ck.label_ref(torch.from_numpy(text_bin).to(dev) != 0,
                          torch.arange(text.size, dtype=torch.int32,
                                       device=dev).reshape(text.shape))
    k3_cases = []
    a, b, counts = run_tables(labels, 128)
    half = int(cpk.compact_ref(a, b, counts, 8192)[2]) // 16   # chunks / 2
    for k, cap8 in ((128, 8192), (128, max(half, 1)), (16, 8192)):
        a, b, counts = run_tables(labels, k)
        want = cpk.compact_ref(a, b, counts, cap8)
        got = cpk.compact_rows(a, b, counts, cap8)
        total, ok = int(want[2]), bool(want[3])
        check(int(got[2]) == total and bool(got[3]) == ok,
              f"K3 total/ok {int(got[2])}/{bool(got[3])} != twin "
              f"{total}/{ok}")
        defined = total if ok else (cap8 - k // 8) * 8
        for g, w_ in zip(got[:2], want[:2]):
            check(torch.equal(g[:defined], w_[:defined]),
                  f"K3 != twin at K={k}, cap8={cap8}")
        k3_cases.append({"K": k, "cap8": cap8, "ok": ok, "total": total,
                         "max_count": int(counts.max())})
    check(not k3_cases[1]["ok"], "the overflow case did not overflow")
    check(k3_cases[2]["max_count"] > 16, "no row has more runs than K=16")
    torch.cuda.synchronize()
    emit({"phase": 6, "k2a_vs_twin": "exact", "k2a_cases": cases,
          "text_partition_vs_scipy": "equal", "k2b_vs_twin": "exact",
          "k2b_ladder_levels": len(pairs), "k3_vs_twin": "exact",
          "k3_cases": k3_cases, "max_abs_err": 0})
    return pairs, labels


@contextlib.contextmanager
def ccl_twins():
    """Route labeling and compaction through the twins (this phase only)."""
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    saved = ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows

    def label(binary, connectivity=8, max_iterations=64):
        h, w = binary.shape
        idx = torch.arange(h * w, dtype=torch.int32,
                           device=binary.device).reshape(h, w)
        return ck.label_ref(binary > 0, idx, connectivity, max_iterations)

    def seeded(binary, init, connectivity=8, max_iterations=64):
        return ck.label_ref(binary > 0, init, connectivity, max_iterations)

    ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows = (
        label, seeded, cpk.compact_ref)
    try:
        yield
    finally:
        ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows = saved


def same(a, b, what: str) -> None:
    for name, x, y in zip(a._fields, a, b):
        check(torch.equal(x, y), f"{what} differs in {name}")


def phase7_text_slice(dev, text: np.ndarray, n_levels: int):
    from scipy import ndimage

    from compv_tpu_torch.core.golden import ccl_summary, mser_summary
    from compv_tpu_torch.features import mser as mser_mod
    from compv_tpu_torch.features.ccl import CclConfig, ccl_features
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    text_bin_np = (text < 128).astype(np.uint8) * 255
    text_bin = torch.from_numpy(text_bin_np).to(dev)
    img = torch.from_numpy(text).to(dev)
    counts = {}

    torch.cuda.synchronize()
    ck.ccl_label.launches = cpk.compact_rows.launches = 0
    res = ccl_features(text_bin, CclConfig())
    torch.cuda.synchronize()
    counts["K2a"], counts["K3"] = ck.ccl_label.launches, cpk.compact_rows.launches
    check(counts["K2a"] == 1 and counts["K3"] == 1,
          f"ccl_features launched K2a {counts['K2a']}x, K3 {counts['K3']}x")
    _, n_scipy = ndimage.label(text_bin_np > 0, structure=np.ones((3, 3)))
    num = int(res.num_components)
    check(num == n_scipy, f"num_components {num} != scipy's {n_scipy}")
    valid = res.valid.cpu().numpy()
    area = res.area.cpu().numpy()
    check(valid.sum() == min(num, 256) and (np.diff(area[valid]) <= 0).all(),
          "CclResult rows not the top-256 by area")
    same(res, ccl_features(text_bin, CclConfig()), "ccl_features repeat")
    with ccl_twins():
        twin = ccl_features(text_bin, CclConfig())
    same(res, twin, "ccl_features kernel vs twin path")

    cfg = MserConfig()
    torch.cuda.synchronize()
    ck.ccl_label_seeded.launches = 0
    mres = mser_detect(img, cfg)
    torch.cuda.synchronize()
    counts["K2b"] = ck.ccl_label_seeded.launches
    syncs = mser_mod.last_syncs
    check(counts["K2b"] == n_levels,
          f"K2b launches {counts['K2b']} != {n_levels} changed levels")
    regions = int(mres.valid.sum())
    check(regions > 0, "mser_detect found no region on the text scene")
    same(mres, mser_detect(img, cfg), "mser_detect repeat")
    with ccl_twins():
        mtwin = mser_detect(img, cfg)
    same(mres, mtwin, "mser_detect kernel vs twin path")
    emit({"phase": 7, "ccl_features": "ok", "num_components": num,
          "scipy_components": int(n_scipy), "ccl_summary": ccl_summary(res),
          "mser_regions": regions, "overflowed": int(mres.overflowed),
          "mser_summary": mser_summary(mres), "host_syncs": syncs,
          "launches": counts,
          "twin_path": "identical CclResult and MserResult"})
    return text_bin, img, res.labels, counts


def phase8_text_times(card: str, text_bin, img, labels, pairs):
    from compv_tpu_torch.features.ccl import (CclConfig,
                                              ccl_features_from_labels,
                                              label_components)
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    rows = {
        "ccl_label_text_ms": cuda_ms(lambda: label_components(text_bin),
                                     reps=20, inner=10),
        "ccl_boxes_text_ms": cuda_ms(
            lambda: ccl_features_from_labels(labels, CclConfig()), reps=20),
        "mser_text_ms": cuda_ms(lambda: mser_detect(img, MserConfig()),
                                reps=5),
    }
    fg = text_bin != 0
    idx = torch.arange(fg.numel(), dtype=torch.int32,
                       device=fg.device).reshape(fg.shape)
    a, b, counts = run_tables(labels, 128)

    def seeded_all(label):
        def run():
            for f, init in pairs:
                label(f, init)
        return run

    times = {
        "K2a": (cuda_ms(lambda: ck.ccl_label(text_bin), reps=20, inner=10),
                cuda_ms(lambda: ck.label_ref(fg, idx, 8), reps=5)),
        "K2b": (cuda_ms(seeded_all(ck.ccl_label_seeded), reps=10) / len(pairs),
                cuda_ms(seeded_all(ck.label_ref), reps=3) / len(pairs)),
        "K3": (cuda_ms(lambda: cpk.compact_rows(a, b, counts, 8192), reps=20,
                       inner=10),
               cuda_ms(lambda: cpk.compact_ref(a, b, counts, 8192), reps=20)),
    }
    emit({"phase": 8, "card": card, **rows,
          **{f"{k}_kernel_us": v[0] * 1e3 for k, v in times.items()},
          **{f"{k}_twin_us": v[1] * 1e3 for k, v in times.items()},
          "k2b_per": "launch, mean over the text ladder's "
                     f"{len(pairs)} changed levels",
          "timing": "median of CUDA-event timings after warm-up"})
    return times


# ---------------------------------------------------------------------------
# the Hough path: SHT accumulator K4, strip label counter K5


def render_board(rows=6, cols=8, square=40, margin=60, angle_deg=0.0):
    """Chessboard with (rows x cols) inner corners, and those corners
    (rows*cols, 2) row-major: a copy of tests/test_checkerboard.py:12-42,
    whose module imports JAX."""
    h = (rows + 1) * square + 2 * margin
    w = (cols + 1) * square + 2 * margin
    yy, xx = np.mgrid[0:h, 0:w]
    if angle_deg:
        th = np.deg2rad(angle_deg)
        cx, cy = w / 2, h / 2
        xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th) + cx
        yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th) + cy
    else:
        xr, yr = xx.astype(float), yy.astype(float)
    ix = np.floor((xr - margin) / square).astype(int)
    iy = np.floor((yr - margin) / square).astype(int)
    board = (((ix + iy) % 2 == 0) & (ix >= 0) & (ix <= cols) & (iy >= 0)
             & (iy <= rows))
    img = np.where(board, 230, 30).astype(np.uint8)
    corners = []
    for r in range(1, rows + 1):
        for c in range(1, cols + 1):
            x = margin + c * square
            y = margin + r * square
            if angle_deg:
                th = np.deg2rad(angle_deg)
                cxy = np.array([w / 2, h / 2])
                p = np.array([x, y]) - cxy
                x, y = (p[0] * np.cos(th) - p[1] * np.sin(th) + cxy[0],
                        p[0] * np.sin(th) + p[1] * np.cos(th) + cxy[1])
            corners.append([x, y])
    return img, np.array(corners)


def sht_args(edges: torch.Tensor, step: float, rho_step: float,
             capacity: int = 65536):
    """K4's arguments as hough_sht builds them from an edge map."""
    from compv_tpu_torch.features.hough import _edge_list
    from compv_tpu_torch.features.hough_trig import theta_count, theta_table

    h, w = edges.shape
    x, y, valid = _edge_list(edges, capacity)
    cos_t, sin_t = theta_table(step, edges.device)
    return (x, y, valid.to(torch.int32), theta_count(step),
            float(np.hypot(h, w)), rho_step, cos_t, sin_t)


def merged_areas(records, used, n: int) -> torch.Tensor:
    """Per-label pixel counts summed over K5's strip records (defined slots
    only), (n,) int64."""
    slot = (torch.arange(records.shape[2], device=records.device)[None, :]
            < used[:, None])
    return torch.zeros(n, dtype=torch.int64, device=records.device
                       ).index_add_(0, records[:, 0, :][slot].long(),
                                    records[:, 1, :][slot].long())


def phase9_hough_kernels_vs_twins(dev, scene: np.ndarray, text: np.ndarray,
                                  pairs, text_labels):
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.ccl import CclConfig, ccl_features
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls

    rs = np.random.default_rng(9)
    dense = np.zeros((480, 640), np.uint8)
    dense[rs.uniform(size=dense.shape) < 0.12] = 255
    dense[40, :] = 255
    dense[:, 200] = 255
    big = ((rs.random((2160, 3840)) < 0.008) * 255).astype(np.uint8)
    maps = {"scene_720p_canny": canny(torch.from_numpy(scene).to(dev),
                                      CannyConfig()),
            "dense_480x640": torch.from_numpy(dense).to(dev),
            "random_2160x3840": torch.from_numpy(big).to(dev)}
    k4_cases = []
    err = {"K4": 0.0, "K5": 0.0}
    for name, e in maps.items():
        for step, rho_step in ((1.0, 1.0), (0.5, 1.0), (1.0, 0.7)):
            args = sht_args(e, step, rho_step)
            got, want = hk.sht_accumulate(*args), hk.sht_accumulate_ref(*args)
            err["K4"] = max(err["K4"], float((got - want).abs().max()))
            check(torch.equal(got, want),
                  f"K4 != twin on {name} at {step} deg, rho {rho_step}")
            votes = args[3] * int(args[2].sum())
            check(int(got.sum()) == votes, f"K4 lost votes on {name}")
            k4_cases.append({"map": name, "theta_step_deg": step,
                             "rho": rho_step, "n_rho": got.shape[1],
                             "edges": int(args[2].sum())})
    check(k4_cases[-3]["n_rho"] == 8813, "4K map's n_rho != 8813")
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    args = (empty, empty, torch.zeros(0, dtype=torch.int32, device=dev),
            *sht_args(maps["dense_480x640"], 1.0, 1.0)[3:])
    got = hk.sht_accumulate(*args)
    check(torch.equal(got, hk.sht_accumulate_ref(*args))
          and int(got.abs().sum()) == 0,
          "K4 on an empty edge list")

    # K5 on the text binary's labels and every changed ladder level
    k5_maps = [("text_binary", text_labels, 256)]
    k5_maps += [(f"ladder_{i}", ck.ccl_label_seeded(fg, init, 8), 640)
                for i, (fg, init) in enumerate(pairs)]
    k5_maps.append(("text_binary_truncating", text_labels, 8))
    truncating = 0
    merged_checked = 0
    for name, lbl, rounds in k5_maps:
        got = ls.strip_label_counts(lbl, rounds)
        want = ls.strip_label_counts_ref(lbl, rounds)
        for g, w_, field in zip(got, want, ("records", "used", "truncated")):
            err["K5"] = max(err["K5"], float((g - w_).abs().max()))
            check(torch.equal(g, w_), f"K5 != twin in {field} on {name}")
        if int(got[2].sum()):
            truncating += 1
            continue
        fg = lbl[lbl >= 0].long()
        check(torch.equal(merged_areas(got[0], got[1], lbl.numel()),
                          torch.bincount(fg, minlength=lbl.numel())),
              f"K5's merged counts != bincount on {name}")
        merged_checked += 1
    check(int(ls.strip_label_counts(text_labels, 8)[2].sum()) > 0,
          "the truncating case did not truncate")
    text_bin = torch.from_numpy((text < 128).astype(np.uint8) * 255).to(dev)
    res = ccl_features(text_bin, CclConfig())
    rec, used, _ = ls.strip_label_counts(text_labels, 256)
    areas = merged_areas(rec, used, text_labels.numel())
    top = torch.sort(areas[areas > 0], descending=True).values
    n_valid = int(res.valid.sum())
    check(torch.equal(top[:n_valid].to(torch.int32), res.area[res.valid]),
          "K5's merged text areas != CclResult.area")
    torch.cuda.synchronize()
    emit({"phase": 9, "k4_vs_twin": "exact", "k4_cases": k4_cases,
          "k4_empty": "exact", "k5_vs_twin": "exact",
          "k5_maps": len(k5_maps), "k5_truncating_maps": truncating,
          "k5_merged_vs_bincount": merged_checked,
          "k5_vs_ccl_area": f"equal on {n_valid} components",
          "max_abs_err": err})
    return err


@contextlib.contextmanager
def hough_twins():
    """Route the SHT accumulator through K4's twin (this phase only)."""
    from compv_tpu_torch.ops.kernels import hough_kernel as hk

    saved = hk.sht_accumulate
    hk.sht_accumulate = hk.sht_accumulate_ref
    try:
        yield
    finally:
        hk.sht_accumulate = saved


def phase10_hough_slice(dev, scene: np.ndarray, text: np.ndarray):
    from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                    find_chessboard_corners)
    from compv_tpu_torch.core.golden import lines_summary
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.ccl import label_components
    from compv_tpu_torch.features.edges import sobel_gradients
    from compv_tpu_torch.features.hough import (HoughKhtConfig,
                                                HoughShtConfig, hough_kht,
                                                hough_sht)
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls

    # the module: the package exports its function under the same name
    canny_mod = importlib.import_module("compv_tpu_torch.features.canny")
    gray = torch.from_numpy(scene).to(dev)
    board_np, truth = render_board(square=80, margin=80, angle_deg=12.0)
    board = torch.from_numpy(board_np).to(dev)
    counts = {}

    torch.cuda.synchronize()
    hk.sht_accumulate.launches = 0
    edges = canny(gray, CannyConfig())
    syncs = canny_mod.last_syncs
    lines = hough_sht(edges, HoughShtConfig())
    torch.cuda.synchronize()
    counts["hough_sht"] = hk.sht_accumulate.launches
    gx, gy = sobel_gradients(gray)
    kht = hough_kht(edges, gx, gy, HoughKhtConfig())
    torch.cuda.synchronize()
    counts["hough_kht"] = hk.sht_accumulate.launches - counts["hough_sht"]
    corners = find_chessboard_corners(board, CheckerboardConfig())
    torch.cuda.synchronize()
    k4_launches = hk.sht_accumulate.launches
    counts["find_chessboard_corners"] = k4_launches - counts["hough_sht"]
    board_syncs = canny_mod.last_syncs
    check(counts == {"hough_sht": 1, "hough_kht": 0,
                     "find_chessboard_corners": 1},
          f"K4 launches {counts}")

    n_lines, n_kht = int(lines.count()), int(kht.count())
    check(n_lines > 0 and n_kht > 0, f"{n_lines} SHT / {n_kht} KHT lines")
    for name, ln in (("hough_sht", lines), ("hough_kht", kht)):
        check(bool(torch.isfinite(ln.rho).all() & torch.isfinite(ln.theta)
                   .all()), f"{name} lines not finite")
    got_c = corners.corners.cpu().numpy().astype(np.float64)
    corner_err = float(np.abs(got_c - truth).max())
    check(bool(corners.valid) and corners.corners.shape == (48, 2),
          "find_chessboard_corners: board not found")
    check(corner_err < 3.0, f"corners {corner_err} px from the truth")

    # the reference's hysteresis cap: does the scene reach it?
    cap = CannyConfig().max_hysteresis_iters
    uncapped = canny(gray, CannyConfig(max_hysteresis_iters=1 << 20))
    cap_loss = int((uncapped != edges).sum())

    same(lines, hough_sht(canny(gray, CannyConfig()), HoughShtConfig()),
         "hough_sht repeat")
    same(kht, hough_kht(edges, gx, gy, HoughKhtConfig()), "hough_kht repeat")
    again = find_chessboard_corners(board, CheckerboardConfig())
    check(torch.equal(corners.corners, again.corners)
          and bool(corners.valid == again.valid), "corners repeat")
    with hough_twins():
        same(lines, hough_sht(edges, HoughShtConfig()),
             "hough_sht kernel vs twin path")
        twin = find_chessboard_corners(board, CheckerboardConfig())
    check(torch.equal(corners.corners, twin.corners),
          "corners kernel vs twin path")
    edges_cpu = canny(gray.cpu(), CannyConfig())
    check(torch.equal(edges.cpu(), edges_cpu), "canny card != CPU")
    lines_cpu = hough_sht(edges_cpu, HoughShtConfig())
    for name, a, b in zip(lines._fields, lines, lines_cpu):
        check(torch.equal(a.cpu(), b), f"hough_sht card != CPU in {name}")
    # reported, not held: the card's atan2 may move a KHT point's centre bin
    kht_cpu = hough_kht(edges_cpu, *sobel_gradients(gray.cpu()),
                        HoughKhtConfig())
    kht_same = all(torch.equal(a.cpu(), b) for a, b in zip(kht, kht_cpu))

    # K5's path: the per-strip component histograms of the MSER probe's
    # ladder (every 5th gray level of the text scene, rounds 640)
    text_t = torch.from_numpy(text).to(dev)
    torch.cuda.synchronize()
    ls.strip_label_counts.launches = 0
    strip = [ls.strip_label_counts(label_components(text_t <= t), 640)
             for t in range(5, 256, 5)]
    torch.cuda.synchronize()
    k5_launches = ls.strip_label_counts.launches
    check(k5_launches == 51, f"K5 launches {k5_launches} != 51 levels")
    used = sum(int(r[1].sum()) for r in strip)
    emit({"phase": 10, "hough_slice": "ok",
          "sht_lines": n_lines, "sht_summary": lines_summary(lines),
          "kht_lines": n_kht, "kht_summary": lines_summary(kht),
          "canny_edges": int((edges > 0).sum()),
          "canny_host_syncs": syncs, "canny_cap": cap,
          "canny_pixels_lost_at_cap": cap_loss,
          "board_shape": list(board_np.shape), "board_valid": True,
          "board_corner_err_px": corner_err,
          "board_canny_host_syncs": board_syncs, "k4_launches": counts,
          "k5_launches": k5_launches, "k5_strip_records_used": used,
          "twin_path": "identical Lines and corners",
          "cpu": "identical canny map and hough_sht Lines",
          "kht_card_equals_cpu": kht_same})
    return gray, edges, board, k4_launches, k5_launches


def phase11_hough_times(card: str, gray, edges, board, text_labels):
    from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                    find_chessboard_corners)
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.edges import sobel_gradients
    from compv_tpu_torch.features.hough import (HoughKhtConfig,
                                                HoughShtConfig, hough_kht,
                                                hough_sht)
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls

    def kht_row():
        e = canny(gray, CannyConfig())
        gx, gy = sobel_gradients(gray)
        return hough_kht(e, gx, gy, HoughKhtConfig())

    rows = {
        "canny3x3_ms": cuda_ms(lambda: canny(gray, CannyConfig()), reps=20),
        "hough_sht_ms": cuda_ms(
            lambda: hough_sht(canny(gray, CannyConfig()), HoughShtConfig()),
            reps=20),
        "hough_kht_ms": cuda_ms(kht_row, reps=20),
        "find_chessboard_corners_ms": cuda_ms(
            lambda: find_chessboard_corners(board, CheckerboardConfig()),
            reps=20),
    }
    args = sht_args(edges, 1.0, 1.0)
    times = {
        "K4": (cuda_ms(lambda: hk.sht_accumulate(*args), reps=20, inner=10),
               cuda_ms(lambda: hk.sht_accumulate_ref(*args), reps=10)),
        "K5": (cuda_ms(lambda: ls.strip_label_counts(text_labels, 256),
                       reps=20, inner=10),
               cuda_ms(lambda: ls.strip_label_counts_ref(text_labels, 256),
                       reps=10)),
    }
    emit({"phase": 11, "card": card, **rows,
          "k4_edge_slots": int(args[0].numel()),
          "k4_valid_edges": int(args[2].sum()),
          **{f"{k}_kernel_us": v[0] * 1e3 for k, v in times.items()},
          **{f"{k}_twin_us": v[1] * 1e3 for k, v in times.items()},
          "k4_at": "720p scene's Canny edge list, 1 deg, rho 1",
          "k5_at": "text binary's 8-conn labels, rounds 256",
          "timing": "median of CUDA-event timings after warm-up"})
    return times


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    dev, card = phase1_device_and_build()
    scene, text = scenes()
    err = phase2_kernel_vs_twin(dev, scene)
    phase3_goldens(dev)
    cfg, img1, img2, k1_launches = phase4_slice(dev, scene)
    kernel_ms, twin_ms = phase5_times(dev, card, cfg, img1, img2)
    pairs, labels = phase6_ccl_kernels_vs_twins(dev, text)
    text_bin, img, labels, launches = phase7_text_slice(dev, text, len(pairs))
    times = phase8_text_times(card, text_bin, img, labels, pairs)
    k45_err = phase9_hough_kernels_vs_twins(dev, scene, text, pairs, labels)
    gray, edges, board, launches["K4"], launches["K5"] = phase10_hough_slice(
        dev, scene, text)
    times.update(phase11_hough_times(card, gray, edges, board, labels))
    launches["K1"] = k1_launches
    times["K1"] = (kernel_ms, twin_ms)
    errs = {"K1": err, "K2a": 0, "K2b": 0, "K3": 0, **k45_err}
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[kid], "max_abs_err": errs[kid],
        "ms": times[kid][0], "plain_ms": times[kid][1]}
        for kid, (name, source, replaces) in KERNELS.items()]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
