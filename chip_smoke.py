"""Smoke test of the PyTorch / CUDA port (compv_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

With --text-kernel-times it only times the labelers, the compactor and the
strip label counter at the text scene's shapes, the FAST kernel at level 0
of the 720p scene (two-output entry) and the SHT accumulator at the scene's
edge list, and prints one JSON line; --package-root DIR takes
compv_tpu_torch from another checkout, so that two versions of a kernel can
be timed in turns on one card:

    python3 chip_smoke.py --text-kernel-times [--package-root DIR]

Phases, each printing its lines before the last:
  1. device and build: the card's name and power limit, the five kernel
     sources built in parallel (one nvcc each), their ptxas lines;
  2. kernel vs twin: the FAST kernel K1 against its plain PyTorch twin, by
     exact equality, on the 720p scene and its pyramid, uniform noise,
     0/255 checkerboards of period 1 and 3, odd sizes, widths of every
     residue mod 4 at heights 1, 7, 8, 9 and a misaligned base, at
     thresholds 0, 20, 40, 255 and N = 9, 12; what the kernel's early-out
     did on the scene and on noise, counted by the kernel and by its model;
  3. goldens on the card: goldens/goldens.json's FAST tuples, homography,
     md5, Otsu, CCL-features and MSER values, computed by the port on the GPU;
  4. the ORB slice: slam.frontend.match_pair on a 720x1282 scene paired
     with its roll by (4, 7), at the full ORB/RANSAC configuration, with the
     kernel's launch count, geometric and determinism checks, and the same
     pair through the kernel's twins;
  5. times of the ORB slice: match_pair and the two-output K1 launch against
     its twin, as medians of CUDA-event timings; K1's device time and bound
     on each of the pair's 8 pyramid levels;
  6. CCL kernels vs twins: the labeler K2a / K2b and the row compactor K3
     against their twins, exact, on bench.py's 1122x1182 text scene (its
     binary at both connectivities, every changed level of its MSER ladder
     at both connectivities, its run tables with and without overflow and
     with a row count that is no multiple of 8), a 1285x1285 random binary,
     a snake and edge shapes, and what stresses K2a's tiling: heights and
     widths one below, at and above a multiple of the tile, a component
     that winds through every tile, a full map, checkerboards of single
     pixels, a 2160x3840 random map; every K2a result also against
     scipy.ndimage.label's partition and a second run; the seeded labeler
     K2b against K2a on every level (from the ladder's seed and from an
     own-index seed), run twice, and on a seed with out-of-range and
     background entries; exactly one device
     operation per compact_rows call, counted as the nodes of a captured
     CUDA graph and, where torch.profiler recorded the window, by it too;
  7. the text-blob slice: features.ccl.ccl_features on the text binary and
     features.mser.mser_detect on the text scene at full width, with launch
     counts, scipy's component count, determinism, and the same calls
     through the twins;
  8. times of the text-blob slice (bench.py's ccl_label_text,
     ccl_boxes_text and mser_text rows, each also under torch.profiler for
     its device-busy time, device operations and idle share) and of K2a,
     K2b and K3 against their twins, as medians of CUDA-event timings;
     K2a and K2b per pass, K2b per ladder level; launches per call of each
     path; the launch floor (one trivial launch through ctypes, back to
     back);
  9. Hough kernels vs twins: the SHT accumulator K4 against its twin,
     exact, on the 720p scene's Canny edge list at 1 and 0.5 degree, a
     dense random map, an empty list, a 2160x3840 map (also at rho steps
     of 0.15 and 0.1, 58,746 and 88,118 bins a theta: wider than a block's
     shared memory, where the kernel tiles rho), lists of 1 and of
     ragged lengths, a list whose edges are scattered with weights above 1,
     arrays off 16 bytes, and 1 and 181 thetas; the strip label
     counter K5 against its twin, exact, on the text binary's labels and
     every changed level of the MSER ladder, on a truncating case, on
     strips of 8 x 8192 and 16 x 4096 labels and on a map of per-pixel
     distinct labels; K5's merged counts against torch.bincount and
     CclResult.area;
 10. the Hough slice: features.canny + features.hough.hough_sht and
     hough_kht on the 720p scene, calib.checkerboard.find_chessboard_corners
     on a rendered 6x8 board 720 rows tall at 12 degrees, with K4's launch
     count, determinism, the twin path, the CPU result and the board's
     truth; hough_sht on a 2160x3840 map at a rho step of 0.1 against the
     CPU run; K5's own path (the per-strip histograms of every ladder
     level);
 11. times of the Hough slice (bench.py's canny3x3, hough_sht and
     hough_kht rows, find_chessboard_corners) and of K4 and K5 against
     their twins, as medians of CUDA-event timings; K4 also at the
     checkerboard's 16,384-slot list and at the 2160x3840 map's 88,118-bin
     accumulator, and one sht_accumulate call as the nodes of a captured
     CUDA graph (one kernel); K5 also on wide strips and per-pixel labels.

The scenes come from bench.py's _images(), loaded by path (its module level
imports numpy only). Any failed check raises, and the script exits
non-zero; so it does without a GPU, and outside a checkout of the
repository. The "kernels" line gives each kernel's launches on its path,
error, time (CUDA events around back-to-back calls, so the host's pace can
enter), device time (the profiler's; a profiler window that comes back
without a device event is taken again, up to three times, and then the
reading is made by CUDA events or left null, counted on the "profiler"
line; --no-profiler makes every reading that way), twin time, bound (the larger of its
bytes over the card's memory rate and its operations over the card's peak
rate, from this run's inputs) and library time (null: no single PyTorch
call computes any of the six functions). The line before the last names the card and its power
limit; the last line of standard output is one JSON object:
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


# torch.profiler windows opened by this run, and how many of them came
# back without a device-side event (the card's tracing can drop a window)
PROFILER = {"windows": 0, "empty": 0, "fallbacks": 0}


def device_events(fn, calls: int = 1, attempts: int = 3):
    """(events, wall ms per call): the device-side events (kernels, copies,
    memsets) torch.profiler records while ``fn`` runs ``calls`` times after
    one warm call, each as (name, microseconds), and the host wall time of
    the profiled window. A window that comes back without a device event is
    taken again, ``attempts`` times in all; ``events`` is empty when none
    of them recorded one, and the caller measures another way."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    events, wall_ms = [], None
    if "--no-profiler" in sys.argv:   # every reading takes its other way
        attempts = 0
    for _ in range(attempts):
        torch.cuda.synchronize()
        PROFILER["windows"] += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
        PROFILER["empty"] += 1
        print("torch.profiler recorded no device event; trying again",
              file=sys.stderr, flush=True)
    return events, wall_ms


def device_profile(fn, ms: float, calls: int = 3) -> dict:
    """Per call of ``fn``, over ``calls`` profiled calls: device-busy ms,
    device operations, the wall ms under the profiler, and the idle share
    1 - busy / ms against ``ms``, the call's time without the profiler.
    Where the profiler recorded nothing, these are not measured (null)."""
    events, wall_ms = device_events(fn, calls)
    if not events:
        PROFILER["fallbacks"] += 1
        return {"busy_ms": None, "device_ops": None,
                "profiled_wall_ms": wall_ms, "idle_share": None}
    busy_ms = sum(us for _, us in events) / 1e3 / calls
    return {"busy_ms": busy_ms, "device_ops": len(events) / calls,
            "profiled_wall_ms": wall_ms, "idle_share": 1 - busy_ms / ms}


def device_ms(fn, calls: int = 10) -> float:
    """Device time per call of ``fn`` in ms: the sum of its device-side
    events under torch.profiler, which the host's pace does not enter.
    Where the profiler recorded nothing: CUDA events around ``calls`` calls
    made back to back, the least of five readings, which the host's pace
    does enter (counted in PROFILER["fallbacks"])."""
    events = device_events(fn, calls)[0]
    if events:
        return sum(us for _, us in events) / 1e3 / calls
    PROFILER["fallbacks"] += 1
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return min(times)


def captured_nodes(fn) -> list:
    """The node types of the CUDA graph that capturing one call of ``fn``
    on a stream gives (0 is a kernel, 1 a copy, 2 a memset): every device
    operation the call issues, counted by libcuda and not by the
    profiler. The graph is never launched."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def ok(code, what):
        check(code == 0, f"{what} returned {code}")

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()                        # the allocator now holds the blocks
        stream.synchronize()
        handle = ctypes.c_void_p(stream.cuda_stream)
        graph = ctypes.c_void_p()
        # mode 2, relaxed: an allocation during the capture is allowed
        ok(cu.cuStreamBeginCapture_v2(handle, 2), "cuStreamBeginCapture")
        try:
            fn()
        finally:
            ok(cu.cuStreamEndCapture(handle, ctypes.byref(graph)),
               "cuStreamEndCapture")
    count = ctypes.c_size_t()
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)),
       "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
       "cuGraphGetNodes")
    types = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int()
        ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        types.append(kind.value)
    ok(cu.cuGraphDestroy(graph), "cuGraphDestroy")
    torch.cuda.synchronize()
    return types


def host_us(fn, n: int = 1000) -> float:
    """Host time per call of ``fn`` in microseconds: ``n`` calls made
    back to back without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


# Peak rates of one H100 SXM (NVIDIA's data sheet): device memory, fp32
# outside the tensor cores (an FMA counts two), and int32 operations, which
# run on half of the fp32 lanes and count one each.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 4


def bound(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations at
    their peak rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(nbytes), "operations": int(ops)}


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase1_device_and_build():
    from compv_tpu_torch.device import require_cuda
    from compv_tpu_torch.ops.kernels import (_build, ccl_kernel,
                                             compact_kernel, fast_kernel,
                                             hough_kernel, label_stats)

    dev = require_cuda()
    card = card_line()
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
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    img = torch.from_numpy(scene).to(dev)
    images = [img] + [scale_bilinear(img, lh, lw)
                      for lh, lw in pyramid_sizes(720, 1282, 8, 0.83)[1:]]
    rs = np.random.default_rng(1)

    def noise(shape):
        return torch.from_numpy(rs.integers(0, 256, shape,
                                            dtype=np.uint8)).to(dev)

    for shape in ((1, 1), (7, 7), (33, 47), (299, 401)):
        images.append(noise(shape))
    n_first = len(images)
    noise_720p = noise((720, 1282))
    images.append(noise_720p)
    yy, xx = np.mgrid[0:131, 0:259]
    for period in (1, 3):
        images.append(torch.from_numpy(
            (((yy // period + xx // period) % 2) * 255).astype(np.uint8)
        ).to(dev))
    # every residue of the width mod 4 (and around the 62-wide tile) at
    # heights below, at and above the 7 rows a strength needs
    for hh in (1, 7, 8, 9):
        for ww in (60, 61, 62, 63, 64, 65, 66, 67):
            images.append(noise((hh, ww)))
    # a base address off 4 bytes: a view into a larger buffer
    flat = noise((3 + 100 * 77,))
    images.extend(flat[off:off + 100 * 77].view(100, 77) for off in (1, 2, 3))
    err = 0.0
    cases = 0
    for i, im in enumerate(images):
        # the earlier cases as they were, the new ones also at the extremes
        for threshold in ((20, 40) if i < n_first else (0, 20, 255)):
            for n in (9, 12):
                err = max(err, kernel_vs_twin(im, threshold, n))
                cases += 1
    # the early-out: the kernel's own counts against the model of its
    # geometry, and the share of warp rows it left with neither side
    early = {}
    for name, im in (("scene_720p", img), ("noise_720p", noise_720p)):
        got = fk.early_out_counts(im, 20, 9)
        want = fk._early_out_counts_ref(im, 20)
        check(torch.equal(got, want), f"K1's early-out counts {got.tolist()}"
              f" != the model's {want.tolist()} on {name}")
        tested, skipped, brighter, darker = got.tolist()
        passing = [int(c.sum()) for c in fk.early_out_candidates(im, 20)]
        early[name] = {"warp_rows_tested": tested,
                       "skipped_share": skipped / tested,
                       "brighter_share": brighter / tested,
                       "darker_share": darker / tested,
                       "pixels_passing_a_test_share":
                           sum(passing) / im.numel()}
    torch.cuda.synchronize()
    emit({"phase": 2, "kernel_vs_twin": "exact", "images": len(images),
          "cases": cases, "max_abs_err": err, "k1_early_out": early})
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


def k1_bound(img: torch.Tensor, threshold: int = 20) -> dict:
    """K1's bound on ``img`` at N = 9, two-output entry. Bytes: the u8
    image read, two f32 maps written. Operations, in the cheapest
    formulation known (two pixels an instruction as 16-bit lanes, three-way
    min / max, the windows on the raw circle pixels so that no tap is
    subtracted), per pixel pair: the opposite-pair test 24 (8 maxima and 8
    minima of c[k], c[k+8], 4 + 4 three-way reductions), the combination 6
    (p + t, the two biased differences, two maxima against the floor, the
    final subtraction), NMS 6 (three three-way maxima, one maximum, compare,
    select): 36 a pair, 18 a pixel; and 40 more a pair and side (16 + 16
    three-way window minima, 8 three-way maxima over the starts) only where
    a pixel of the pair passes that side's test, since every other pixel's
    strength is exactly 0. ``worst_ms`` is the same with every pair needing
    both sides."""
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    def pairs(cand):
        cand = torch.nn.functional.pad(cand, (0, cand.shape[1] % 2))
        return int((cand[:, 0::2] | cand[:, 1::2]).sum())

    n = img.numel()
    brighter, darker = fk.early_out_candidates(img, threshold)
    out = bound(n + 2 * 4 * n, 18 * n + 40 * (pairs(brighter) + pairs(darker)),
                INT32_OPS_PER_S)
    out["worst_ms"] = bound(n + 2 * 4 * n, 18 * n + 80 * ((n + 1) // 2),
                            INT32_OPS_PER_S)["bound_ms"]
    return out


def phase5_times(dev, card: str, cfg, img1, img2):
    from compv_tpu_torch.features.orb import PATCH_DIAMETER
    from compv_tpu_torch.image.pyramid import pyramid_sizes
    from compv_tpu_torch.image.scale import scale_bilinear
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.slam.frontend import match_pair

    pair_ms = cuda_ms(lambda: match_pair(img1, img2, cfg), reps=20)
    kernel_ms = cuda_ms(lambda: fk.fast_strengths_and_nms(img1, 20, 9),
                        reps=20, inner=50)

    def twin():
        s = fk._strengths_ref(img1, 20, 9)
        return s, fk._nms_ref(s)

    twin_ms = cuda_ms(twin, reps=20, inner=5)
    dev_ms = device_ms(lambda: fk.fast_strengths_and_nms(img1, 20, 9))
    bound0 = k1_bound(img1)
    # the level images of the pair's first frame, as the ORB loop makes them
    levels = []
    h, w = img1.shape
    for lv, (lh, lw) in enumerate(pyramid_sizes(h, w, cfg.orb.levels,
                                                cfg.orb.scale_factor)):
        if lh < PATCH_DIAMETER + 2 or lw < PATCH_DIAMETER + 2:
            continue
        im = img1 if lv == 0 else scale_bilinear(img1, lh, lw)
        bnd = k1_bound(im)
        us = dev_ms * 1e3 if lv == 0 else device_ms(
            lambda im=im: fk.fast_strengths_and_nms(im, 20, 9)) * 1e3
        levels.append({"shape": [lh, lw], "device_us": us,
                       "bound_us": bnd["bound_ms"] * 1e3,
                       "bound_by": bnd["bound_by"],
                       "worst_case_bound_us": bnd["worst_ms"] * 1e3})
    check(all(lv["bound_us"] <= lv["device_us"] for lv in levels),
          f"a K1 bound above its device time: {levels}")
    emit({"phase": 5, "card": card, "match_pair_720p_ms": pair_ms,
          "k1_two_output_level0_us": kernel_ms * 1e3,
          "k1_device_us": dev_ms * 1e3,
          "k1_twin_level0_us": twin_ms * 1e3,
          "k1_bound_us": bound0["bound_ms"] * 1e3,
          "k1_bound_by": bound0["bound_by"],
          "k1_worst_case_bound_us": bound0["worst_ms"] * 1e3,
          "k1_levels": levels,
          "k1_device_us_per_match_pair":
              2 * sum(lv["device_us"] for lv in levels),
          "k1_gap_us_per_match_pair":
              2 * sum(lv["device_us"] - lv["bound_us"] for lv in levels),
          "timing": "median of 20 CUDA-event timings after warm-up; device "
                    "times by the profiler"})
    return (kernel_ms, twin_ms, dev_ms), bound0


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


def ladder(f: torch.Tensor, config, connectivity: int = 8):
    """The (fg, init, labels) triples of MSER's ladder on ``f`` (dark
    mode): one per changed level, each seeded by the previous level's
    labels, which are the twin's."""
    from compv_tpu_torch.features.mser import ladder_levels
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck

    levels = ladder_levels(config)[2]
    h, w = f.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=f.device).reshape(h, w)
    lbl = torch.full((h, w), -1, dtype=torch.int32, device=f.device)
    triples = []
    for t in levels:
        fg = f <= t
        if bool((fg != (lbl >= 0)).any()):
            init = torch.where(lbl >= 0, lbl, idx)
            lbl = ck.label_ref(fg, init, connectivity, 1000)
            triples.append((fg, init, lbl))
    return triples


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
    # what stresses a tiling of 32 rows by 32 or 64 columns
    for hh in (31, 32, 33, 63, 64, 65):
        for ww in (31, 32, 33, 63, 64, 65):
            binaries[f"{hh}x{ww}"] = (rs.random((hh, ww)) < 0.55
                                      ).astype(np.uint8)
    serpent = np.zeros((200, 301), np.uint8)
    for k, r in enumerate(range(0, 200, 2)):
        serpent[r, :] = 1
        if r + 2 < 200:
            serpent[r:r + 2, 300 if k % 2 == 0 else 0] = 1
    yy, xx = np.mgrid[0:131, 0:197]
    binaries.update({
        "serpent": serpent, "all_fg_1182x1122": np.ones((1182, 1122),
                                                        np.uint8),
        "checker": ((yy + xx) % 2).astype(np.uint8),
        "checker_odd": ((yy + xx + 1) % 2).astype(np.uint8),
        # below the 8-connected percolation threshold, so that the twin's
        # pointer stage converges
        "random_2160x3840": (rs.random((2160, 3840)) < 0.35).astype(np.uint8),
    })
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
            check(np.array_equal(got.cpu().numpy(), oracle_labels(b, conn)),
                  f"K2a's partition != scipy.ndimage.label's on {name}, "
                  f"connectivity {conn}")
            check(torch.equal(ck.ccl_label(t, conn), got),
                  f"K2a differs from run to run on {name}")
            cases += 1

    # K2b on every changed level of the text ladder: the twin's labels,
    # K2a's labels, the same from an own-index seed, the same again
    f = torch.from_numpy(text).to(dev)
    idx = torch.arange(text.size, dtype=torch.int32,
                       device=dev).reshape(text.shape)
    ladders = {conn: ladder(f, MserConfig(), conn) for conn in (8, 4)}
    for conn, triples in ladders.items():
        for fg, init, want in triples:
            got = ck.ccl_label_seeded(fg, init, conn)
            where = f"a level of the {conn}-connected text ladder"
            check(torch.equal(got, want), f"K2b != twin on {where}")
            check(torch.equal(got, ck.ccl_label(fg, conn)),
                  f"K2b != K2a on {where}")
            check(torch.equal(ck.ccl_label_seeded(fg, idx, conn), got),
                  f"K2b from an own-index seed != K2a on {where}")
            check(torch.equal(ck.ccl_label_seeded(fg, init, conn), got),
                  f"K2b differs from run to run on {where}")
    pairs = [(fg, init) for fg, init, _ in ladders[8]]

    # a seed with entries below 0, past the own index, on background and
    # (at background pixels, never read) anywhere: still in bounds, and the
    # labels of the mask
    fg, init, want = ladders[8][len(pairs) // 2]
    bad = init.clone().reshape(-1)
    on = torch.nonzero(fg.reshape(-1))[:, 0]
    off = torch.nonzero(~fg.reshape(-1))[:, 0]
    gen = torch.Generator(device="cpu").manual_seed(6)
    hit = on[torch.randperm(on.numel(), generator=gen)[:40000].to(dev)]
    bad[hit[:10000]] = -1
    bad[hit[10000:20000]] = 2 ** 31 - 1
    bad[hit[20000:30000]] = torch.clamp(hit[20000:30000] + 1,
                                        max=text.size - 1).to(torch.int32)
    below = torch.searchsorted(off, hit[30000:]) - 1
    bad[hit[30000:]] = off[torch.clamp(below, min=0)].to(torch.int32)
    bad[off] = torch.randint(-2 ** 31, 2 ** 31 - 1, (off.numel(),),
                             generator=gen, dtype=torch.int64
                             ).to(torch.int32).to(dev)
    check(torch.equal(ck.ccl_label_seeded(fg, bad.reshape(fg.shape), 8),
                      want), "K2b on a seed with invalid entries")

    labels = ck.label_ref(torch.from_numpy(text_bin).to(dev) != 0,
                          torch.arange(text.size, dtype=torch.int32,
                                       device=dev).reshape(text.shape))
    k3_cases = []
    a, b, counts = run_tables(labels, 128)
    half = int(cpk.compact_ref(a, b, counts, 8192)[2]) // 16   # chunks / 2
    for k, cap8, rows in ((128, 8192, 1182), (128, max(half, 16), 1182),
                          (16, 8192, 1182), (128, 8192, 1179)):
        a, b, counts = (t[:rows] for t in run_tables(labels, k))
        want = cpk.compact_ref(a, b, counts, cap8)
        got = cpk.compact_rows(a, b, counts, cap8)
        total, ok = int(want[2]), bool(want[3])
        check(got[2].dtype == torch.int32 and got[3].dtype == torch.bool
              and int(got[3].view(torch.uint8)) in (0, 1),
              "K3's total / ok types")
        check(int(got[2]) == total and bool(got[3]) == ok,
              f"K3 total/ok {int(got[2])}/{bool(got[3])} != twin "
              f"{total}/{ok}")
        defined = total if ok else (cap8 - k // 8) * 8
        for g, w_ in zip(got[:2], want[:2]):
            check(torch.equal(g[:defined], w_[:defined]),
                  f"K3 != twin at K={k}, cap8={cap8}, H={rows}")
        k3_cases.append({"K": k, "cap8": cap8, "H": rows, "ok": ok,
                         "total": total, "max_count": int(counts.max())})
    check(not k3_cases[1]["ok"], "the overflow case did not overflow")
    check(k3_cases[2]["max_count"] > 16, "no row has more runs than K=16")
    a, b, counts = run_tables(labels, 128)
    k3_nodes = captured_nodes(lambda: cpk.compact_rows(a, b, counts, 8192))
    check(k3_nodes == [0], "compact_rows made other device operations "
          f"than one kernel: node types {k3_nodes}")
    # the twin's offsets alone (its indexed copy waits for the host, which
    # a capture does not allow): the operations K3 now does inside
    ref_nodes = captured_nodes(lambda: cpk._offsets(counts, 128, 8192))
    check(len(ref_nodes) > 1, "the capture does not count the twin's "
          f"offset operations: node types {ref_nodes}")
    k3_ops, _ = device_events(lambda: cpk.compact_rows(a, b, counts, 8192))
    check(len(k3_ops) <= 1,
          f"compact_rows made {len(k3_ops)} device operations: {k3_ops}")
    torch.cuda.synchronize()
    emit({"phase": 6, "k2a_vs_twin": "exact", "k2a_cases": cases,
          "k2a_vs_scipy": "equal on every case", "k2a_repeat": "identical",
          "k2b_vs_twin": "exact",
          "k2b_ladder_levels": {c: len(t) for c, t in ladders.items()},
          "k2b_vs_k2a": "equal from the ladder's seed and an own-index "
                        "seed, twice", "k2b_invalid_seed": "exact",
          "k3_vs_twin": "exact", "k3_cases": k3_cases,
          "k3_device_ops_per_call": {
              "captured_graph_nodes": len(k3_nodes),
              "twin_offsets_captured_graph_nodes": len(ref_nodes),
              "torch_profiler": len(k3_ops) or None}, "max_abs_err": 0})
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


def launch_floor_ms() -> float:
    """One trivial launch through ctypes, back to back: K3's entry on an
    8-row table with every output allocated beforehand."""
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    dev = torch.device("cuda", 0)
    table = torch.zeros((8, 8), dtype=torch.int32, device=dev)
    counts = torch.ones((8,), dtype=torch.int32, device=dev)
    out = torch.empty((128,), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    lib = cpk._kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (table.data_ptr(), table.data_ptr(), counts.data_ptr(),
            out.data_ptr(), out.data_ptr(), total.data_ptr(), ok.data_ptr(),
            8, 8, 16, stream)

    def launch():
        check(lib.compv_compact_rows(*args) == 0, "trivial launch failed")

    return cuda_ms(launch, reps=20, inner=200)


def phase8_text_times(card: str, text_bin, img, labels, pairs, launches):
    from compv_tpu_torch.features.ccl import (CclConfig,
                                              ccl_features_from_labels,
                                              label_components)
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk

    calls = {
        "ccl_label_text": lambda: label_components(text_bin),
        "ccl_boxes_text": lambda: ccl_features_from_labels(labels,
                                                           CclConfig()),
        "mser_text": lambda: mser_detect(img, MserConfig()),
    }
    rows = {
        "ccl_label_text_ms": cuda_ms(calls["ccl_label_text"], reps=20,
                                     inner=10),
        "ccl_boxes_text_ms": cuda_ms(calls["ccl_boxes_text"], reps=20),
        "mser_text_ms": cuda_ms(calls["mser_text"], reps=5),
    }
    profiles = {name: device_profile(fn, rows[f"{name}_ms"])
                for name, fn in calls.items()}
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
                cuda_ms(lambda: ck.label_ref(fg, idx, 8), reps=5),
                device_ms(lambda: ck.ccl_label(text_bin))),
        "K2b": (cuda_ms(seeded_all(ck.ccl_label_seeded), reps=10) / len(pairs),
                cuda_ms(seeded_all(ck.label_ref), reps=3) / len(pairs),
                device_ms(seeded_all(ck.ccl_label_seeded), 1) / len(pairs)),
        "K3": (cuda_ms(lambda: cpk.compact_rows(a, b, counts, 8192), reps=20,
                       inner=10),
               cuda_ms(lambda: cpk.compact_ref(a, b, counts, 8192), reps=20),
               device_ms(lambda: cpk.compact_rows(a, b, counts, 8192))),
    }
    # K2b level by level, and the device time of its passes over the ladder
    per_level = [cuda_ms(lambda f=f, i=i: ck.ccl_label_seeded(f, i), reps=5,
                         inner=10) * 1e3 for f, i in pairs]
    passes = {}
    for name, us in device_events(seeded_all(ck.ccl_label_seeded))[0]:
        passes[name] = passes.get(name, 0.0) + us / len(pairs)
    k2a_passes = {}
    for name, us in device_events(lambda: ck.ccl_label(text_bin), 10)[0]:
        k2a_passes[name] = k2a_passes.get(name, 0.0) + us / 10
    k3_host_us = host_us(lambda: cpk.compact_rows(a, b, counts, 8192))
    empty_host_us = host_us(lambda: torch.empty(
        (65536,), dtype=torch.int32, device=fg.device))
    n = fg.numel()
    total = int(cpk.compact_ref(a, b, counts, 8192)[2])
    # bytes: the mask and the seed read once, the label map written once;
    # the records K3 copies, in and out, and its counts. Operations: about
    # ten int32 operations a pixel (index, compares, one find step) and
    # two a copied record, far below the bytes' time.
    bounds = {
        "K2a": bound(n + 4 * n, 10 * n, INT32_OPS_PER_S),
        "K2b": bound(n + 4 * n + 4 * n, 10 * n, INT32_OPS_PER_S),
        "K3": bound(4 * counts.numel() + 2 * 2 * 4 * total + 5, 2 * 2 * total,
                    INT32_OPS_PER_S),
    }
    emit({"phase": 8, "card": card, **rows, "profiles": profiles,
          **{f"{k}_kernel_us": v[0] * 1e3 for k, v in times.items()},
          **{f"{k}_twin_us": v[1] * 1e3 for k, v in times.items()},
          **{f"{k}_device_us": v[2] * 1e3 for k, v in times.items()},
          **{f"{k}_bound_us": v["bound_ms"] * 1e3 for k, v in bounds.items()},
          "k2b_per": "launch, mean over the text ladder's "
                     f"{len(pairs)} changed levels",
          "k2b_per_level_us": per_level,
          "k2b_device_us_per_pass": passes,
          "k2a_device_us_per_pass": k2a_passes,
          "k3_host_us": k3_host_us, "torch_empty_host_us": empty_host_us,
          "launch_floor_us": launch_floor_ms() * 1e3,
          "launches_per_call": {"label_components": {"K2a": launches["K2a"]},
                                "ccl_features": {"K2a": launches["K2a"],
                                                 "K3": launches["K3"]},
                                "mser_detect": {"K2b": launches["K2b"]}},
          "timing": "median of CUDA-event timings after warm-up"})
    return times, bounds


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
    # rows wider than a block's shared memory: the kernel tiles rho
    for rho_step, n_rho in ((0.15, 58746), (0.1, 88118)):
        args = sht_args(maps["random_2160x3840"], 1.0, rho_step)
        got, want = hk.sht_accumulate(*args), hk.sht_accumulate_ref(*args)
        check(got.shape == (180, n_rho), f"n_rho {got.shape[1]} != {n_rho}")
        err["K4"] = max(err["K4"], float((got - want).abs().max()))
        check(torch.equal(got, want),
              f"K4 != twin on the 2160x3840 map at rho {rho_step}")
        check(int(got.sum()) == args[3] * int(args[2].sum()),
              f"K4 lost votes at rho {rho_step}")
        k4_cases.append({"map": "random_2160x3840", "theta_step_deg": 1.0,
                         "rho": rho_step, "n_rho": n_rho,
                         "edges": int(args[2].sum())})
        del got, want
    empty = torch.zeros(0, dtype=torch.float32, device=dev)
    args = (empty, empty, torch.zeros(0, dtype=torch.int32, device=dev),
            *sht_args(maps["dense_480x640"], 1.0, 1.0)[3:])
    got = hk.sht_accumulate(*args)
    check(torch.equal(got, hk.sht_accumulate_ref(*args))
          and int(got.abs().sum()) == 0,
          "K4 on an empty edge list")
    # the shapes of the split: lists of 1, of ragged lengths around a group
    # of 2048 slots and 8 x 512 and past 65,536; edges scattered over the
    # list with weights above 1; arrays off 16 bytes; 1 and 181 thetas
    base = sht_args(maps["scene_720p_canny"], 1.0, 1.0)
    gen = torch.Generator(device="cpu").manual_seed(9)
    perm = torch.randperm(65536, generator=gen).to(dev)
    heavy = base[2] * torch.randint(1, 5, (65536,), generator=gen,
                                    dtype=torch.int32).to(dev)
    extra = {"scattered_weights_1_to_4": (base[0][perm], base[1][perm],
                                          heavy[perm], *base[3:]),
             "off_16_bytes": (base[0][1:], base[1][1:], base[2][1:],
                              *base[3:]),
             "theta_1": (*base[:3], 1, base[4], base[5],
                         base[6][:1].contiguous(), base[7][:1].contiguous()),
             "theta_181": (*base[:3], 181, base[4], base[5],
                           torch.cat([base[6], base[6][:1]]),
                           torch.cat([base[7], base[7][:1]]))}
    for e in (1, 3, 2047, 2049, 4097, 10000, 65535):
        extra[f"E_{e}"] = (base[0][perm[:e]], base[1][perm[:e]],
                           base[2][perm[:e]], *base[3:])
    long = torch.cat([perm, perm[:4465]])
    extra["E_70001"] = (base[0][long], base[1][long], base[2][long],
                        *base[3:])
    for name, args in extra.items():
        got, want = hk.sht_accumulate(*args), hk.sht_accumulate_ref(*args)
        err["K4"] = max(err["K4"], float((got - want).abs().max()))
        check(torch.equal(got, want), f"K4 != twin on {name}")
        check(int(got.sum()) == args[3] * int(args[2].sum()),
              f"K4 lost votes on {name}")
        k4_cases.append({"map": name, "n_theta": args[3],
                         "slots": int(args[0].numel()),
                         "votes_per_theta": int(args[2].sum())})
    plans = {name: hk.sht_plan(n_theta, n_rho, dev) for name, n_theta, n_rho
             in (("720p_1deg", 180, 2942), ("720p_half_deg", 360, 2942),
                 ("2160x3840_1deg", 180, 8813), ("theta_1", 1, 2942),
                 ("2160x3840_rho_0.15", 180, 58746),
                 ("2160x3840_rho_0.1", 180, 88118),
                 ("theta_1_rho_0.1", 1, 88118))}
    check(plans["720p_1deg"] == (6, 4, 1)
          and plans["2160x3840_1deg"] == (6, 4, 1),
          f"K4's plans at the path's shapes moved: {plans}")
    check(plans["2160x3840_rho_0.1"][2] > 1, "no rho tiles at n_rho 88,118")

    # K5 on the text binary's labels and every changed ladder level
    k5_maps = [("text_binary", text_labels, 256)]
    k5_maps += [(f"ladder_{i}", ck.ccl_label_seeded(fg, init, 8), 640)
                for i, (fg, init) in enumerate(pairs)]
    k5_maps.append(("text_binary_truncating", text_labels, 8))
    # strips of 65,536 labels, twice what a block's shared memory holds,
    # and the worst case of the run compression: every pixel its own label
    wide = ck.ccl_label(torch.from_numpy(
        (rs.random((32, 8192)) < 0.45).astype(np.uint8)).to(dev), 8)
    k5_maps += [("wide_8x8192", wide, 256),
                ("wide_16x4096", wide[:, :4096].contiguous(), 256),
                ("per_pixel_labels", torch.arange(
                    64 * 1122, dtype=torch.int32, device=dev
                ).reshape(64, 1122).flip(1).contiguous(), 256),
                ("per_pixel_labels_rounds_11000", torch.arange(
                    16 * 1122, dtype=torch.int32, device=dev
                ).reshape(16, 1122), 11000)]
    truncating = 0
    merged_checked = 0
    for name, lbl, rounds in k5_maps:
        rows = 16 if name == "wide_16x4096" else 8
        got = ls.strip_label_counts(lbl, rounds, rows)
        want = ls.strip_label_counts_ref(lbl, rounds, rows)
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
          "k4_empty": "exact",
          "k4_thetas_per_cta_ctas_per_cluster_and_rho_tiles": plans,
          "k5_vs_twin": "exact",
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

    # a theta row of 88,118 bins (the rho-tiled kernel): card against CPU
    rs = np.random.default_rng(10)
    big = torch.from_numpy(((rs.random((2160, 3840)) < 0.004) * 255
                            ).astype(np.uint8))
    big[1000, 200:3600] = 255
    big[300:1900, 2222] = 255
    fine = HoughShtConfig(rho=0.1, threshold=0.5, max_lines=16)
    before = hk.sht_accumulate.launches
    wide_lines = hough_sht(big.to(dev), fine)
    check(hk.sht_accumulate.launches == before + 1,
          "hough_sht at rho 0.1 did not launch K4")
    wide_cpu = hough_sht(big, fine)
    check(int(wide_lines.count()) > 0, "hough_sht at rho 0.1 found no line")
    for name, a, b in zip(wide_lines._fields, wide_lines, wide_cpu):
        check(torch.equal(a.cpu(), b),
              f"hough_sht at rho 0.1, card != CPU in {name}")

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
          "hough_sht_2160x3840_rho_0.1": {
              "lines": int(wide_lines.count()), "cpu": "identical Lines"},
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
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
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
    # the checkerboard's list: Canny at 40 / 100, 16,384 slots
    board_args = sht_args(canny(board, CheckerboardConfig().canny), 1.0, 1.0,
                          16384)
    board_us = device_ms(lambda: hk.sht_accumulate(*board_args)) * 1e3
    # the rho-tiled form: a 2160x3840 map at rho 0.1, 88,118 bins a theta
    rs = np.random.default_rng(9)
    wide_args = sht_args(torch.from_numpy(
        ((rs.random((2160, 3840)) < 0.008) * 255).astype(np.uint8)
    ).to(gray.device), 1.0, 0.1)
    wide_us = device_ms(lambda: hk.sht_accumulate(*wide_args)) * 1e3
    wide_acc = hk.sht_accumulate(*wide_args)
    wide_bound = bound(3 * 4 * wide_args[0].numel() + 2 * 4 * wide_args[3]
                       + 4 * wide_acc.numel(),
                       7 * int(wide_args[2].sum()) * wide_args[3],
                       FP32_OPS_PER_S)
    wide_plan = hk.sht_plan(wide_args[3], wide_acc.shape[1], gray.device)
    del wide_acc
    # K5 where the first kernel raised, and at the run compression's worst
    dev = text_labels.device
    wide_labels = ck.ccl_label(torch.from_numpy(
        (rs.random((32, 8192)) < 0.45).astype(np.uint8)).to(dev), 8)
    per_pixel = torch.arange(64 * 1122, dtype=torch.int32,
                             device=dev).reshape(64, 1122)
    k5_other_us = {
        "4_strips_of_8x8192": device_ms(
            lambda: ls.strip_label_counts(wide_labels, 256)) * 1e3,
        "8_strips_of_8x1122_per_pixel_labels": device_ms(
            lambda: ls.strip_label_counts(per_pixel, 256)) * 1e3}
    k4_nodes = captured_nodes(lambda: hk.sht_accumulate(*args))
    check(k4_nodes == [0], "sht_accumulate made other device operations "
          f"than one kernel: node types {k4_nodes}")
    times = {
        "K4": (cuda_ms(lambda: hk.sht_accumulate(*args), reps=20, inner=10),
               cuda_ms(lambda: hk.sht_accumulate_ref(*args), reps=10),
               device_ms(lambda: hk.sht_accumulate(*args))),
        "K5": (cuda_ms(lambda: ls.strip_label_counts(text_labels, 256),
                       reps=20, inner=10),
               cuda_ms(lambda: ls.strip_label_counts_ref(text_labels, 256),
                       reps=10),
               device_ms(lambda: ls.strip_label_counts(text_labels, 256))),
    }
    # K4: the edge list (x, y, weight) and the trig table read, the
    # accumulator written; a vote (fused multiply-add, multiply, add,
    # multiply, round, add) is seven fp32 operations, one per valid edge and
    # theta. K5: the label map read, the strip records written; about four
    # int32 operations a pixel.
    slots, valid, n_theta = int(args[0].numel()), int(args[2].sum()), args[3]
    acc = hk.sht_accumulate(*args)
    k5_out = ls.strip_label_counts(text_labels, 256)
    bounds = {
        "K4": bound(3 * 4 * slots + 2 * 4 * n_theta + 4 * acc.numel(),
                    7 * valid * n_theta, FP32_OPS_PER_S),
        "K5": bound(4 * text_labels.numel()
                    + sum(t.numel() * t.element_size() for t in k5_out),
                    4 * text_labels.numel(), INT32_OPS_PER_S),
    }
    emit({"phase": 11, "card": card, **rows,
          "k4_edge_slots": slots, "k4_valid_edges": valid,
          **{f"{k}_bound_us": v["bound_ms"] * 1e3 for k, v in bounds.items()},
          **{f"{k}_kernel_us": v[0] * 1e3 for k, v in times.items()},
          **{f"{k}_twin_us": v[1] * 1e3 for k, v in times.items()},
          **{f"{k}_device_us": v[2] * 1e3 for k, v in times.items()},
          "k4_at": "720p scene's Canny edge list, 1 deg, rho 1",
          "k4_board_device_us": board_us,
          "k4_board_slots": int(board_args[0].numel()),
          "k4_board_valid_edges": int(board_args[2].sum()),
          "k4_captured_graph_nodes": len(k4_nodes),
          "k4_plan": hk.sht_plan(n_theta, acc.shape[1], gray.device),
          "k4_wide": {"n_rho": hk.n_rho_bins(wide_args[4], wide_args[5]),
              "edges": int(wide_args[2].sum()), "plan": wide_plan,
              "device_us": wide_us,
              "bound_us": wide_bound["bound_ms"] * 1e3},
          "k5_other_device_us": k5_other_us,
          "k5_at": "text binary's 8-conn labels, rounds 256",
          "timing": "median of CUDA-event timings after warm-up"})
    return times, bounds


def text_kernel_times(package_root: str) -> int:
    """From the package under ``package_root``: K2a, K2b (mean and per
    level over the text ladder), K3's wrapper and K5 at the text scene's
    shapes, K1's two-output entry at level 0 of the 720p scene and K4 at
    the scene's Canny edge list, by CUDA events, and each one's device time
    by the profiler."""
    sys.path.insert(0, package_root)
    from compv_tpu_torch.device import require_cuda
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.mser import MserConfig
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls

    dev = require_cuda()
    scene, text = scenes()
    text_bin = torch.from_numpy((text < 128).astype(np.uint8) * 255).to(dev)
    labels = ck.ccl_label(text_bin)
    check(np.array_equal(labels.cpu().numpy(),
                         oracle_labels(text_bin.cpu().numpy(), 8)),
          "K2a != scipy's partition on the text binary")
    for got, want in zip(ls.strip_label_counts(labels, 256),
                         ls.strip_label_counts_ref(labels, 256)):
        check(torch.equal(got, want), "K5 != twin on the text labels")
    pairs = [(fg, init) for fg, init, _ in ladder(
        torch.from_numpy(text).to(dev), MserConfig())]
    a, b, counts = run_tables(labels, 128)
    for fg, init in pairs:
        check(torch.equal(ck.ccl_label_seeded(fg, init), ck.ccl_label(fg)),
              "K2b != K2a on a level of the text ladder")
    gray = torch.from_numpy(scene).to(dev)
    raw = fk._strengths_ref(gray, 20, 9)
    for got, want in zip(fk.fast_strengths_and_nms(gray, 20, 9),
                         (raw, fk._nms_ref(raw))):
        check(torch.equal(got, want), "K1 != twin on the 720p scene")
    sht = sht_args(canny(gray, CannyConfig()), 1.0, 1.0)
    check(torch.equal(hk.sht_accumulate(*sht), hk.sht_accumulate_ref(*sht)),
          "K4 != twin on the 720p scene's edge list")

    def seeded_all():
        for fg, init in pairs:
            ck.ccl_label_seeded(fg, init)

    # K2a off its path: a small and a large noise map at density one half
    # (near percolation, most unions a pixel), a full map, single pixels
    rs = np.random.default_rng(2)
    yy, xx = np.mgrid[0:1182, 0:1122]
    others = {"noise_64x80": rs.random((64, 80)) < 0.5,
              "noise_1285x1285": rs.random((1285, 1285)) < 0.5,
              "noise_2160x3840": rs.random((2160, 3840)) < 0.5,
              "full_1182x1122": np.ones((1182, 1122), bool),
              "checkerboard_1182x1122": (yy + xx) % 2 == 0}
    k2a_other = {}
    for name, mask in others.items():
        t = torch.from_numpy(mask.astype(np.uint8)).to(dev)
        check(np.array_equal(ck.ccl_label(t).cpu().numpy(),
                             oracle_labels(mask, 8)),
              f"K2a != scipy's partition on {name}")
        k2a_other[name] = device_ms(lambda: ck.ccl_label(t)) * 1e3

    emit({"package_root": os.path.abspath(package_root),
          "card": card_line(),
          "K1_device_us": device_ms(
              lambda: fk.fast_strengths_and_nms(gray, 20, 9)) * 1e3,
          "K4_device_us": device_ms(lambda: hk.sht_accumulate(*sht)) * 1e3,
          "K2a_device_us": device_ms(lambda: ck.ccl_label(text_bin)) * 1e3,
          "K2a_other_device_us": k2a_other,
          "K2b_device_us": device_ms(seeded_all, 1) / len(pairs) * 1e3,
          "K5_device_us": device_ms(
              lambda: ls.strip_label_counts(labels, 256)) * 1e3,
          "K3_device_us": device_ms(
              lambda: cpk.compact_rows(a, b, counts, 8192)) * 1e3,
          "K1_us": cuda_ms(lambda: fk.fast_strengths_and_nms(gray, 20, 9),
                           reps=20, inner=50) * 1e3,
          "K4_us": cuda_ms(lambda: hk.sht_accumulate(*sht), reps=20,
                           inner=10) * 1e3,
          "K2a_us": cuda_ms(lambda: ck.ccl_label(text_bin), reps=20,
                            inner=10) * 1e3,
          "K2b_us": cuda_ms(seeded_all, reps=20) / len(pairs) * 1e3,
          "K2b_levels": len(pairs),
          "K2b_per_level_us": [cuda_ms(
              lambda f=f, i=i: ck.ccl_label_seeded(f, i), reps=5, inner=10)
              * 1e3 for f, i in pairs],
          "K3_us": cuda_ms(lambda: cpk.compact_rows(a, b, counts, 8192),
                           reps=20, inner=10) * 1e3,
          "K5_us": cuda_ms(lambda: ls.strip_label_counts(labels, 256),
                           reps=20, inner=10) * 1e3,
          "timing": "median of CUDA-event timings after warm-up; device "
                    "times by the profiler"})
    return 0


def main() -> int:
    if "--text-kernel-times" in sys.argv[1:]:
        root = ROOT
        if "--package-root" in sys.argv:
            root = sys.argv[sys.argv.index("--package-root") + 1]
        return text_kernel_times(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    dev, card = phase1_device_and_build()
    scene, text = scenes()
    err = phase2_kernel_vs_twin(dev, scene)
    phase3_goldens(dev)
    cfg, img1, img2, k1_launches = phase4_slice(dev, scene)
    k1_times, k1_bound = phase5_times(dev, card, cfg, img1, img2)
    pairs, labels = phase6_ccl_kernels_vs_twins(dev, text)
    text_bin, img, labels, launches = phase7_text_slice(dev, text, len(pairs))
    times, bounds = phase8_text_times(card, text_bin, img, labels, pairs,
                                      launches)
    k45_err = phase9_hough_kernels_vs_twins(dev, scene, text, pairs, labels)
    gray, edges, board, launches["K4"], launches["K5"] = phase10_hough_slice(
        dev, scene, text)
    k45_times, k45_bounds = phase11_hough_times(card, gray, edges, board,
                                                labels)
    times.update(k45_times)
    bounds.update(k45_bounds)
    launches["K1"] = k1_launches
    times["K1"] = k1_times
    bounds["K1"] = k1_bound
    errs = {"K1": err, "K2a": 0, "K2b": 0, "K3": 0, **k45_err}
    # library_ms: no single PyTorch call computes any of the six functions
    # (K4's twin is a bin computation plus scatter_add_, K5's a torch.unique
    # per strip plus a bincount; FAST, the labelers and the ragged copy
    # have none)
    emit({"profiler": PROFILER, "note": "windows that held no "
          "device event were taken again; a fallback is a reading made "
          "without the profiler (CUDA events) or left null"})
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[kid], "max_abs_err": errs[kid],
        "ms": times[kid][0], "plain_ms": times[kid][1],
        "device_ms": times[kid][2], "bound_ms": bounds[kid]["bound_ms"],
        "bound_by": bounds[kid]["bound_by"], "library_ms": None}
        for kid, (name, source, replaces) in KERNELS.items()]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
