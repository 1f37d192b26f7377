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

With --sfm-128 it only makes goldens/sfm_128.json's run (phase 13's third
run, without the resume) and prints its numbers, with the count of Schur
steps whose reduced system failed to factor or held a non-finite entry;
--package-root takes the package from another checkout here too:

    python3 chip_smoke.py --sfm-128 [--package-root DIR]

With --distributed it only runs phase 21, after the 128-frame run (with
its resume) whose checkpoint phase 21 resumes; with --trace-probe it only
counts the K1 kernels that torch.profiler windows and profiling.trace
windows hold against K1's launch counter (1 and 30 launches a window, in
a fresh process and after a load of other work):

    python3 chip_smoke.py --distributed
    python3 chip_smoke.py --trace-probe

With --examples it only runs phase 22, with --bench only phase 23, with
--sweep only phase 24, with --orient only phase 25 and with --level-areas
only phase 26 (each after phase 1's build):

    python3 chip_smoke.py --examples
    python3 chip_smoke.py --bench
    python3 chip_smoke.py --sweep
    python3 chip_smoke.py --orient
    python3 chip_smoke.py --level-areas

Phases, each printing its lines before the last:
  1. device and build: the card's name and power limit, the seven kernel
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
     launch counts of K1 and of the orientation kernel K6, geometric and
     determinism checks, and the same pair through both kernels' twins; the card's ORB of both images against
     the port's on the CPU (keypoints' x, y, level, strength and valid
     equal, orientations within ORIENTATION_TOL_DEG, the descriptor bits
     that differ counted and each traced to the angle, the card's cos / sin
     or the blurred pixels that moved it) and match_pair on the CPU by
     tests/test_torch_frontend.py's bars;
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
     counts (K7 once a changed ladder level, as K2b), scipy's component
     count, determinism, and the same calls through the twins;
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
     distinct labels, and at rounds 11,520 and 65,536 (its list in device
     memory, past a block's shared memory); K5's merged counts against
     torch.bincount and CclResult.area;
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
     CUDA graph (one kernel); K5 also on wide strips and per-pixel labels;
 12. SfM components on the card against the port on the CPU, same inputs:
     find_essential and solve_pnp (sample indices and inliers exact, poses
     within 2e-4 / 1e-4), ba_step on the golden BA problem (goldens.json's
     cost and camera hash), ba_solve and ba_solve_schur on a 32-camera,
     32,768-observation problem (cost and parameters within tolerance, two
     card runs bit-identical);
 13. the SfM slice at full width: sfm_ate at goldens/sfm.json (8 frames,
     240x320) and sfm_long.json (32 frames, 480x640; phase 14's profiled
     run is its second run, and identical),
     each held to the reference tests' bars, with K1's launches per
     run_sfm; the 128-frame 480x640 run of scripts/make_goldens.py's
     sfm_128_config (Schur, an 8-frame window, checkpoints) held to
     sfm_128.json's bars, and resume_sfm from its last checkpoint; a
     6-frame 120x160 run on the card against the CPU (tracks, bootstrap
     pair and essential inliers equal);
 14. times of the SfM slice at sfm_long: run_sfm per frame split by stage
     (CUDA events around each stage of phase 13's sfm_long run), one
     ba_solve and one ba_solve_schur at the final BA's shape, and device
     busy, idle share and launches per frame under torch.profiler, whose
     run is phase 13's sfm_long run again (identical); the depths and
     repeats that PLANAR_FRAMES, RECORDING_FRAMES, LIVE_FRAMES and
     TIMING_REPS set were cut to fit the run in half its limit;
 15. slice 3 at full width, with K1 and K4 launches counted from 0 on each
     path: calibration from images (8 views of 720x1280 of the 6x8 board of
     80-px squares warped through K = f 1000 at known poses ->
     find_chessboard_corners, K4 once a view -> calibrate_camera, Zhang and
     40 LM steps -> undistort_image, undistort_points), held to the
     reference tests' bars and to the port on the CPU on the same corners;
     track_planar_sequence on PLANAR_FRAMES (4) frames of the 720x1282
     scene, each turned
     0.3 degrees and shifted (4, 2) px more than the last (K1 on 4 levels of
     every frame), the chained H against the truth, inlier counts on the
     card and the CPU, decompose_homography and KeyframeStore;
     optimize_pose_graph on a graph of sphere2500's size made from a seed
     (2,500 poses, 4,949 edges), its cost ratio against the reference's
     (POSEGRAPH_REF_RATIO), the CPU's cost, and a second card run
     (identical); fit_line / fit_parabola through ransac and the distances
     on 65,536 points with 30 % outliers against the CPU; the slice-1/2
     leftovers (Q0.16 blur, nearest / bicubic scaling, both rotations, 2-D
     and wide convolutions, the pyramid, popcount, threefry.normal, masked
     statistics) on the card against the CPU;
 16. times of slice 3 (CUDA events) with device busy, idle share and
     launches by torch.profiler: find_chessboard_corners per view,
     calibrate_camera, the 8-view calibration path (K4 kernels counted in
     the trace), undistort_image at 720x1280, track_planar_sequence per
     frame (K1 kernels counted in the trace) and optimize_pose_graph;
 17. slice 4 at full width, each part against the port on the CPU, with
     every hand kernel's count at 0 after it (no Pallas kernel lies on
     this path): (a) bench.py's slice-4 image rows on its own inputs (the
     720x1282 scene, its rolled RGB, the seeded I420 chroma, the 1285x1285
     binary; bench.py:109-125) and the other conversions, LUT,
     projections and morph operators, bit-equal to the CPU but the float32
     integral images (1e-6 relative), and the goldens md5_rgb_to_hsv,
     md5_integral, md5_erode_3x3, md5_dilate_3x3 computed on the card;
     (b) moments, fast_atan2_deg of the scene's Sobel gradients against
     the exact angle, saturating ops on 720p u8 / i16 / u16 planes, batched
     eigen_symm / svd / pseudo_inverse / inverse_3x3 with singular members;
     (c) HOG at 720x1282, every interp mode with L2-Hys and every norm with
     bilinear, by the tests' tolerances (pixels whose vote moves bin
     counted with one-pixel cells), two card runs identical; (d) the
     classifier path: every 128x64 window of the dense descriptor (11,475
     of 3,780 values), labels from the scene's checkerboard patch, RBF and
     linear SVMs trained on 2,048 (numpy seed 0), PCA to 64 and a 5-NN
     vote, each window count within 2 of the reference's (HOG_SVM_REF,
     from scripts/hog_svm_reference.py) and labels as the CPU's wherever
     |decision| >= 1e-3, the ANN index's recall against exact search, and
     platt_fit against scipy's minimum;
 18. times of slice 4 (CUDA events) with device busy, idle share and
     launches by torch.profiler: bench.py's slice-4 rows by their names,
     hog_8x8_l2hys, svm_train on 2,048 windows, svm_decision on 11,475,
     pca_compute (11,475 x 3,780 -> 64) and knn_search (11,475 queries);
 19. slice 5 at full width, the host layer driven as the reference's two
     demo paths: the native runtime built by g++ under build/ (the tracked
     native/libcompv_native.so's sha256 the same before and after); a YAML
     file through load_config to phase 4's configuration; every algorithm
     that list_algorithms() lists and the registry creates (orb, fast, mser
     through K2b, canny, sobel, scharr, prewitt, bruteforce) once on
     the 720x1282 scene, each equal to its direct call, and a MserConfig
     saved and loaded again running mser_detect; the recording path
     (examples/object_recognition.py's chain): RECORDING_FRAMES (8) I420
     frames of the scene,
     frame t rolled by (2t, 3t), written with VideoWriterRaw, read back by
     open_video through the native loader with recycled staging buffers
     (each Y plane's native md5 as written, in order), uploaded, each later
     frame matched against the first by match_pair (K1 16 times a pair),
     drawn with draw_matches + draw_text (equal to a CPU draw of the card's
     results) and written (7 x 720 x 2564 x 3 bytes), each pair held to
     the reference's counts and H (RECORDING_REF, from
     scripts/recording_reference.py); the live path (examples/live_demo.py's
     chain): SyntheticCamera(1280, 720, 30 fps, LIVE_FRAMES = 15 frames) ->
     run_live ->
     the registry's ORB (K1 on 8 levels) + draw_keypoints + draw_text,
     pushed into a recording sink and, where PIL imports, the port's
     MjpegServer (its /snapshot read back), stopped by the camera's
     exhaustion, the last frame reproduced; trace() around two recording
     frames names K1, each K1 launch in a profiler range of its own, so
     that a launch the window lacks is named with its frame, stage, level
     and whether its runtime call was traced; device_memory_stats() on
     the card;
 20. times of the two demo paths: ms a frame by Timer stage (read, upload,
     match_pair, ORB + KNN for the drawing, draw, write; upload + ORB and
     draw for the live loop), the live loop's frames/s, and device busy,
     launches and idle share under torch.profiler over 4 frames of each;
 21. slice 6, the chain of examples/distributed_sfm.py on two ranks
     spawned on the card (gloo, every tensor staged through host memory;
     nccl, one rank a card, where there are two cards or more), the
     kernels built once by this process: sharded_orb_detect on phase 19's
     32 frames of 720x1282 at OrbConfig() (K1 launched on each rank; each
     frame bit-equal to orb_detect_describe here), sharded_all_pairs_match
     and ring_all_pairs_match (bit-equal to the single-process (32, 32)
     matrix, zero diagonal), the psum, reduce-scatter and Schur BA steps
     at 256 cameras / 20,000 landmarks / 100,000 observations (seed 11),
     each twice and bit-identical, held to the single-process step by the
     reference's tolerances (the Schur step below half the cost), and
     resume_sfm of phase 13's 128-frame checkpoint on the two ranks, held
     to phase 13's resume bar and sfm_128.json's; each stage's time
     between barriers and the bytes staged. A rank that fails fails the
     script;
 22. the port's six example programs (examples_torch/, the counterparts of
     examples/): each run as a program on the card (python
     examples_torch/<name>.py; live_demo for LIVE_DEMO_SECONDS (2 s) on a
     free port,
     distributed_sfm at its default --ranks, one rank a card, and at
     --ranks 2, two ranks on the card over gloo), its printed numbers held
     to EXAMPLES_REF (the reference programs' output, from
     scripts/examples_reference.py) by the CPU tests' bars and its wall
     seconds printed with the card's name and power limit; each
     single-process program run again in this process with the hand
     kernels' counts read around its main() (K1 and K6 once a pyramid
     level of each ORB in object_recognition, planar_tracking and
     live_demo; K4 once
     in edge_lines and once a view in camera_calibration; every other count
     0) and its full-precision results held to EXAMPLES_REF; and once on
     the CPU, whose written images the card run's are compared with (equal
     where the CPU port is equal to the reference, else within the pixel
     counts the CPU tests state). A program that fails fails the script;
 23. the port's measurement programs: bench_torch.py (bench.py's 29 rows
     through the port) as a program on the card at a --target-diff of
     BENCH_TARGET_DIFF, beside its --once run on the CPU: 29 row lines in
     bench.py's order and the suite_geomean_vs_reference line, each naming
     the card, no error line and rc 0; each row's checksum from one call on
     the card equal to the CPU's (accumulators within BENCH_ACC_REL) and
     the hand kernels that call launched as BENCH_LAUNCHES (K1 once in the
     FAST row, K1 and the orientation kernel K6 16 times each in
     frontend_pair_720p, K2a in ccl_label_text, K3
     in ccl_boxes_text, K2b and K7 49 times each in mser_text, K4 in
     hough_sht, none
     elsewhere); then each row's call in this process, timed by CUDA
     events and under torch.profiler (device busy, launches, idle share),
     and scripts/roofline_torch.py's K1, K2a and K4 rows, each share of
     its bound at most 100 %;
 24. the differential sweep on the card: every case of
     tests/test_torch_parity_cases.py (loaded by path; over 1,200 cases
     of the public functions of math/, ops/, image/, features/, matchers/,
     calib/ and slam/ by dtype and shape, which the CPU tests hold to the
     reference)
     through the port on the card and on the CPU, held to each other by
     the case's rule: the same exception class where one raises, else the
     same structure, dtypes and shapes, integers bit-equal and floats
     within the case's tolerance; each of the table's CARD_FAULTS must
     still differ. Counts by module and by dtype;
 25. (run after phase 5) ORB's orientation kernel K6, which replaces no
     TPU kernel: at the 720p scene's 8 pyramid levels with the keypoints,
     budgets and valid flags of ORB's level loop, each call equal to its
     twin on the card for the u8 level and an f32 image with fractions,
     one counted launch and one kernel node a call; per level its device
     and event time, the twin's time and its bound (the disc pixels read
     once at 3.35 TB/s, or the moments' f32 operations);
 26. (run after phase 8) MSER's ladder level areas K7, which replaces no
     TPU kernel: at every changed level of the text scene's ladder (K2b's
     labels, 1182 x 1122), each call equal to its twin on the card (root,
     area, over), one counted launch and three kernel nodes a call, the
     scratch table zero after the ladder; device time a call by its three
     kernels and level by level, event time, the twin's device and event
     time and device operations a level, and its bound (the labels read
     once and the candidate table written once at 3.35 TB/s).

Each phase prints its wall seconds on a line of its own ({"phase_s":
...}), and the line before the card's gives them all with the total.

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
call computes any of the six functions); K1-K4 also give their launches
in one call of each bench_torch.py row (phase 23). The line before the
last names the card and its power limit; the last line of standard output
is one JSON object:
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
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


# The depths and timing repeats of the earlier paths, cut to fit the whole
# run in half its 1,200 s limit (the value before the cut in the comment):
# no kernel-vs-twin check, golden, path or phase is dropped.
PLANAR_FRAMES = 4           # 16: phase 15's planar tracking sequence
RECORDING_FRAMES = 8        # 32: phase 19's recorded frames
LIVE_FRAMES = 15            # 60: phase 19's live frames
LIVE_DEMO_SECONDS = "2"     # "3": phase 22's live_demo program
# phase 14 times the stages of phase 13's sfm_long run (3 timed runs of
# its own before) and profiles its second run (2 runs in phase 13 before)
TIMING_REPS = {             # cuda_ms repeats a reading, by phase and call
    "pair": 5,              # 20: phase 5, match_pair and K1 / twin
    "sfm_ba": 1,            # 3: phase 14, ba_solve / ba_solve_schur
    "corners": 1,           # 3: phase 16, find_chessboard_corners
    "calibration": 1,       # 2: phase 16, calibrate_camera / the path
    "undistort": 3,         # 10: phase 16, undistort_image
    "track": 1,             # 2: phase 16, track_planar_sequence
    "posegraph": 1,         # 2: phase 16, optimize_pose_graph
    "bench_here": 3,        # 5: phase 23, each row's call here
    "orient": 5,            # phase 25, the orientation kernel / twin
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


def device_events(fn, calls: int = 1, attempts: int = 3, warm: bool = True):
    """(events, wall ms per call): the device-side events (kernels, copies,
    memsets) torch.profiler records while ``fn`` runs ``calls`` times (after
    one warm call, unless ``warm`` is False), each as (name, microseconds),
    and the host wall time of the profiled window. The events are read
    from the trace's raw records of device activity (the parse into
    FunctionEvents takes minutes at a million events and is never made). A
    window that comes back without a device event is taken again,
    ``attempts`` times in all; ``events`` is empty when none of them
    recorded one, and the caller measures another way."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    events, wall_ms = [], None
    if "--no-profiler" in sys.argv:   # every reading takes its other way
        attempts = 0
    for _ in range(attempts):
        torch.cuda.synchronize()
        PROFILER["windows"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        events = [(e.name(), e.duration_ns() / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        if events:
            break
        PROFILER["empty"] += 1
        print("torch.profiler recorded no device event; trying again",
              file=sys.stderr, flush=True)
    return events, wall_ms


def device_profile(fn, ms: float, calls: int = 3,
                   kernel_names: dict | None = None) -> dict:
    """Per call of ``fn``, over ``calls`` profiled calls: device-busy ms,
    device operations and kernel launches among them, the wall ms under the
    profiler, the idle share 1 - busy / ms against ``ms``, the call's time
    without the profiler, and for each entry of ``kernel_names`` ({key:
    substring}) the launches of the kernels whose name holds it. Where the
    profiler recorded nothing, these are not measured (null)."""
    events, wall_ms = device_events(fn, calls)
    if not events:
        PROFILER["fallbacks"] += 1
        return {"busy_ms": None, "device_ops": None, "kernel_launches": None,
                "profiled_wall_ms": wall_ms, "idle_share": None,
                **{key: None for key in kernel_names or {}}}
    kernels = [e for e in events if not e[0].startswith(("Memcpy", "Memset"))]
    busy_ms = sum(us for _, us in events) / 1e3 / calls
    return {"busy_ms": busy_ms, "device_ops": len(events) / calls,
            "kernel_launches": len(kernels) / calls,
            "profiled_wall_ms": wall_ms, "idle_share": 1 - busy_ms / ms,
            **{key: sum(1 for name, _ in kernels if sub in name) / calls
               for key, sub in (kernel_names or {}).items()}}


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
    from compv_tpu_torch import native_rt
    from compv_tpu_torch.device import require_cuda
    from compv_tpu_torch.ops.kernels import (_build, ccl_kernel,
                                             compact_kernel, fast_kernel,
                                             hough_kernel, label_stats,
                                             level_areas, orient_kernel)

    dev = require_cuda()
    card = card_line()
    emit(card)
    names = ("fast_kernel", "ccl_kernel", "compact_kernel", "hough_kernel",
             "label_stats", "orient_kernel", "level_areas")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names) + 1) as pool:
        native = pool.submit(native_rt.native_available)   # g++, slice 5
        paths = dict(zip(names, pool.map(_build.build, names)))
        check(native.result(), "g++ did not build the native runtime")
    for module in (fast_kernel, ccl_kernel, compact_kernel, hough_kernel,
                   label_stats, orient_kernel, level_areas):
        module._kernel_lib()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in path.with_suffix(".log").read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name, path in paths.items()}
    emit({"phase": 1, "device": torch.cuda.get_device_name(dev), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3),
          "libraries": [p.name for p in paths.values()],
          "native_runtime": native_rt.library_path().name, "ptxas": ptxas})
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
        pairs.append((fk.fast_strengths_nms(img, threshold, n, nms,
                                            as_f32=True), want))
        pairs.append((fk.fast_strengths_nms(img, threshold, n, nms,
                                            as_f32=False),
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
def orb_twins():
    """Route the ORB level loop through the plain twins of K1 and of the
    orientation kernel (this phase only)."""
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    saved = fk.fast_strengths_and_nms, fk.fast_strengths_nms
    saved_orient = ok.patch_orientation

    def both(img, threshold=20, n=9):
        s = fk._strengths_ref(img, threshold, n)
        return s, fk._nms_ref(s)

    def one(img, threshold=20, n=9, nms=True, as_f32=False):
        s = fk._strengths_ref(img, threshold, n)
        s = fk._nms_ref(s) if nms else s
        return s if as_f32 else s.to(torch.uint8)

    fk.fast_strengths_and_nms, fk.fast_strengths_nms = both, one
    ok.patch_orientation = ok._orientation_ref
    try:
        yield
    finally:
        fk.fast_strengths_and_nms, fk.fast_strengths_nms = saved
        ok.patch_orientation = saved_orient


def phase4_slice(dev, scene: np.ndarray):
    from compv_tpu_torch.features.orb import (PATCH_DIAMETER, OrbConfig,
                                              orb_detect_describe)
    from compv_tpu_torch.calib.homography import HomographyConfig
    from compv_tpu_torch.image.pyramid import pyramid_sizes
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import orient_kernel as ok
    from compv_tpu_torch.slam.frontend import FrontendConfig, match_pair

    cfg = FrontendConfig(orb=OrbConfig(max_features=2000, levels=8),
                         homography=HomographyConfig())
    img1 = torch.from_numpy(scene).to(dev)
    img2 = torch.roll(img1, (4, 7), (0, 1))
    levels_used = sum(1 for lh, lw in pyramid_sizes(720, 1282, 8, 0.83)
                      if lh >= PATCH_DIAMETER + 2 and lw >= PATCH_DIAMETER + 2)

    torch.cuda.synchronize()
    fk.launches = ok.launches = 0
    res = match_pair(img1, img2, cfg)
    torch.cuda.synchronize()
    launches = fk.launches
    check(launches == 2 * levels_used,
          f"K1 launches {launches} != 2 images x {levels_used} levels")
    check(ok.launches == 2 * levels_used,
          f"orientation kernel launches {ok.launches} != 2 images x "
          f"{levels_used} levels")

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

    with orb_twins():
        twin = [orb_detect_describe(im, cfg.orb) for im in (img1, img2)]
    for im, ref in zip((img1, img2), twin):
        got = orb_detect_describe(im, cfg.orb)
        for name in got.keypoints._fields:
            check(torch.equal(getattr(got.keypoints, name),
                              getattr(ref.keypoints, name)),
                  f"kernel vs twin keypoints differ in {name}")
        check(torch.equal(got.descriptors, ref.descriptors),
              "kernel vs twin descriptors differ")
    on_cpu = orb_card_vs_cpu(cfg, (img1, img2), res)
    emit({"phase": 4, "match_pair": "ok", "kp1_count": int(res.kp1_count),
          "kp2_count": int(res.kp2_count), "num_matches": num_matches,
          "num_inliers": num_inliers, "shift_err_px": err_px,
          "k1_launches": launches, "levels_used": levels_used,
          "twin_path": "identical keypoints and descriptors",
          "card_vs_cpu": on_cpu})
    return cfg, img1, img2, launches


# card vs CPU: largest difference of a keypoint's orientation, in degrees
# (an ulp of atan2 near 360 is 3e-5; a sample of BRIEF's radius-15 patch
# moves 2.6e-4 px for 1e-3 degrees)
ORIENTATION_TOL_DEG = 1e-3


def brief_samples(deg: torch.Tensor, trig_device) -> torch.Tensor:
    """(256, 4) rounded rotated BRIEF sample offsets (ax, ay, bx, by) for
    one keypoint angle, as features.orb.brief_describe computes them, with
    cos / sin taken on ``trig_device`` and the products on the host (the
    same IEEE products on either device)."""
    from compv_tpu_torch.features.orb import _DEG2RAD, _pattern_on

    pat = _pattern_on(torch.device("cpu"))
    th = deg.reshape(1).to(trig_device) * _DEG2RAD
    c, s = th.cos().cpu(), th.sin().cpu()
    out = []
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        out += [(px * c - py * s).round(), (px * s + py * c).round()]
    return torch.stack(out, dim=1).to(torch.int64)


def brief_causes(dev, card_calls: list, cpu_calls: list) -> dict:
    """For each BRIEF bit that differs between the card's and the CPU's
    brief_describe calls (one call a pyramid level, same inputs but for
    what each device computed), what moved it: the keypoint's angle
    (atan2 on the card; the samples rotated by the card's angle with the
    host's cos / sin land elsewhere), the card's cos / sin of the same
    angle, or the blurred pixels sampled."""
    causes = {"angle": 0, "cos_sin": 0, "blur": 0, "not_found": 0}
    examples = []
    for lv, (card, cpu) in enumerate(zip(card_calls, cpu_calls,
                                         strict=True)):
        (bc, xc, yc, oc, vc, dc), (bp, xp, yp, op, vp, dp) = card, cpu
        check(torch.equal(xc, xp) and torch.equal(yc, yp)
              and torch.equal(vc, vp), f"level {lv}: BRIEF inputs differ")
        diff = (dc != dp) & vp[:, None]
        h, w = bp.shape
        for r in diff.any(dim=1).nonzero().flatten().tolist():
            at_cpu = brief_samples(op[r], "cpu")
            at_angle = brief_samples(oc[r], "cpu")
            at_card = brief_samples(oc[r], dev)
            for j in diff[r].nonzero().flatten().tolist():
                if not torch.equal(at_angle[j], at_cpu[j]):
                    cause = "angle"
                elif not torch.equal(at_card[j], at_angle[j]):
                    cause = "cos_sin"
                else:
                    xi, yi = int(xp[r].round()), int(yp[r].round())
                    ax, ay, bx, by = at_cpu[j].tolist()

                    def px(b, dx, dy):
                        return float(b[min(max(yi + dy, 0), h - 1),
                                       min(max(xi + dx, 0), w - 1)])
                    moved = (px(bc, ax, ay), px(bc, bx, by)) != \
                        (px(bp, ax, ay), px(bp, bx, by))
                    cause = "blur" if moved else "not_found"
                causes[cause] += 1
                if len(examples) < 6:
                    examples.append({
                        "level": lv, "x": float(xp[r]), "y": float(yp[r]),
                        "deg_card": float(oc[r]), "deg_cpu": float(op[r]),
                        "bit": j, "cause": cause,
                        "samples_cpu": at_cpu[j].tolist(),
                        "samples_card": at_card[j].tolist()})
    return {"bits_by_cause": causes, "examples": examples}


def orb_card_vs_cpu(cfg, imgs, res) -> dict:
    """Phase 4's two 720p images through orb_detect_describe on the card
    and on the port's CPU path: keypoints (x, y, level, strength, valid)
    equal, orientations within ORIENTATION_TOL_DEG, the descriptor bits
    that differ counted and each traced to its cause (brief_causes); and
    match_pair's card result (``res``) against the CPU's by
    tests/test_torch_frontend.py's bars (counts equal, matches within 2 %,
    inliers within 3 %, H within 0.05 px over phase 4's grid)."""
    from compv_tpu_torch.features import orb as orb_mod
    from compv_tpu_torch.slam.frontend import match_pair

    def described(img):
        calls, real = [], orb_mod.brief_describe

        def spy(blurred, x, y, deg, valid):
            out = real(blurred, x, y, deg, valid)
            calls.append([t.cpu() for t in (blurred, x, y, deg, valid, out)])
            return out
        orb_mod.brief_describe = spy
        try:
            return orb_mod.orb_detect_describe(img, cfg.orb), calls
        finally:
            orb_mod.brief_describe = real

    images = []
    for img in imgs:
        (card, card_calls), (cpu, cpu_calls) = described(img), \
            described(img.cpu())
        kc, kp = to_cpu(card.keypoints), cpu.keypoints
        for name in ("x", "y", "level", "strength", "valid"):
            check(torch.equal(getattr(kc, name), getattr(kp, name)),
                  f"720p ORB: keypoint {name} differs between card and CPU")
        v = kp.valid
        d = (kc.orientation - kp.orientation).abs()[v].double()
        d = torch.minimum(d, 360.0 - d)
        max_deg = float(d.max()) if d.numel() else 0.0
        check(max_deg <= ORIENTATION_TOL_DEG,
              f"720p ORB: orientations {max_deg} degrees apart")
        bits = (card.descriptors.cpu() != cpu.descriptors) & v[:, None]
        images.append({
            "keypoints": int(v.sum()), "equal": "x, y, level, strength, valid",
            "orientations_differing": int((d > 0).sum()),
            "max_orientation_deg": max_deg,
            "descriptor_bits_differing": int(bits.sum()),
            "descriptors_differing": int(bits.any(dim=1).sum()),
            "of_bits": int(v.sum()) * bits.shape[1],
            **brief_causes(imgs[0].device, card_calls, cpu_calls)})
    cpu_res = match_pair(imgs[0].cpu(), imgs[1].cpu(), cfg)
    n, k = int(res.num_matches), int(res.num_inliers)
    cn, ck = int(cpu_res.num_matches), int(cpu_res.num_inliers)
    gy, gx = np.mgrid[100:621:40, 100:1181:60].astype(np.float64)
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])
    h_px = projection_gap(res.h.cpu(), cpu_res.h, p)
    check(int(res.kp1_count) == int(cpu_res.kp1_count)
          and int(res.kp2_count) == int(cpu_res.kp2_count)
          and abs(n - cn) <= 0.02 * cn and abs(k - ck) <= 0.03 * ck
          and h_px <= 0.05,
          f"match_pair card ({n}, {k}) vs CPU ({cn}, {ck}), H {h_px} px")
    return {"orb": images, "match_pair_cpu": [cn, ck],
            "match_pair_card": [n, k], "h_card_vs_cpu_px": h_px}


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

    pair_ms = cuda_ms(lambda: match_pair(img1, img2, cfg),
                      reps=TIMING_REPS["pair"])
    kernel_ms = cuda_ms(lambda: fk.fast_strengths_and_nms(img1, 20, 9),
                        reps=TIMING_REPS["pair"], inner=50)

    def twin():
        s = fk._strengths_ref(img1, 20, 9)
        return s, fk._nms_ref(s)

    twin_ms = cuda_ms(twin, reps=TIMING_REPS["pair"], inner=5)
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
# ORB's orientation kernel (K6): it replaces no TPU kernel; eager PyTorch
# made the twin's dense moment maps ~380 launches an image and level


def orient_calls(img: torch.Tensor, cfg) -> list:
    """(level image, x, y, valid) of each orientation call that one
    orb_detect_describe of ``img`` makes, as its level loop makes them."""
    from compv_tpu_torch.features.orb import orb_detect_describe
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    calls, real = [], ok.patch_orientation

    def spy(im, x, y, valid):
        calls.append((im, x, y, valid))
        return real(im, x, y, valid)
    ok.patch_orientation = spy
    try:
        orb_detect_describe(img, cfg)
    finally:
        ok.patch_orientation = real
    return calls


def orient_bound(img: torch.Tensor, x, y, valid) -> dict:
    """K6's bound on one call. Bytes: the image pixels that the valid
    keypoints' discs cover, each read once; x, y and valid read, the angles
    written. Operations: per valid keypoint and moment a subtraction, a
    multiplication and an addition for each of the disc's 339 steps and
    30 additions to fold its rows (atan2 not counted)."""
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    h, w = img.shape
    r = ok.RADIUS
    offs = [(dy, dx) for dy in range(-r, r + 1)
            for dx in range(-ok.HALF_WIDTHS[abs(dy)],
                            ok.HALF_WIDTHS[abs(dy)] + 1)]
    off = torch.tensor(offs, device=img.device)
    xi = x.round().to(torch.int64).clamp(r, w - 1 - r)[valid]
    yi = y.round().to(torch.int64).clamp(r, h - 1 - r)[valid]
    py = yi[:, None] + off[None, :, 0]
    px = xi[:, None] + off[None, :, 1]
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    pixels = int(torch.unique((py * w + px)[inside]).numel())
    steps = sum(ok.HALF_WIDTHS[abs(d)] for d in range(-r, r + 1))
    kv = int(valid.sum())
    out = bound(pixels * img.element_size() + 13 * x.numel(),
                kv * 2 * (3 * steps + 2 * r), FP32_OPS_PER_S)
    out["disc_pixels"] = pixels
    return out


def phase25_orient_kernel(dev, card: str, scene: np.ndarray) -> dict:
    """K6 at the cam720p cell's shapes: the 8 level images of the 720x1282
    scene with the keypoints, budgets and valid flags that ORB's level loop
    gives them. Each call against its twin on the card, exact, as u8 and
    as an f32 image with fractions (where the order of the sums shows),
    one launch counted and one device operation (a captured graph's nodes)
    a call; then, per level, device time (profiler), event time (CUDA
    events, 50 calls back to back), the twin's time and the bound."""
    from compv_tpu_torch.features.orb import OrbConfig
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    img1 = torch.from_numpy(scene).to(dev)
    calls = orient_calls(img1, OrbConfig())
    check(len(calls) == 8, f"{len(calls)} orientation calls, not 8")
    gen = torch.Generator(device=dev).manual_seed(25)
    reps = TIMING_REPS["orient"]
    levels = []
    for lv, (im, x, y, valid) in enumerate(calls):
        frac = im.to(torch.float32) * 1.37 + torch.rand(
            im.shape, generator=gen, device=dev)
        for img in (im, frac):
            before = ok.launches
            got = ok.patch_orientation(img, x, y, valid)
            check(ok.launches == before + 1, "K6 did not count its launch")
            want = ok._orientation_ref(img, x, y, valid)
            check(torch.equal(got, want),
                  f"level {lv} {img.dtype}: K6 != twin in "
                  f"{int((got != want).sum())} of {got.numel()} angles")

        def call(im=im, x=x, y=y, valid=valid):
            return ok.patch_orientation(im, x, y, valid)

        nodes = captured_nodes(call)
        check(nodes == [0], f"level {lv}: a call issued {nodes}, not one "
                            "kernel")
        bnd = orient_bound(im, x, y, valid)
        dev_us = device_ms(call, calls=20) * 1e3
        levels.append({
            "shape": list(im.shape), "keypoints": x.numel(),
            "valid": int(valid.sum()), "disc_pixels": bnd["disc_pixels"],
            "device_us": dev_us,
            "event_us": cuda_ms(call, reps=reps, inner=50) * 1e3,
            "twin_us": cuda_ms(lambda im=im, x=x, y=y, valid=valid:
                               ok._orientation_ref(im, x, y, valid),
                               reps=reps, inner=5) * 1e3,
            "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"],
            "f32_image": "equal to the twin"})
    check(all(lv["bound_us"] <= lv["device_us"] for lv in levels),
          f"a K6 bound above its device time: {levels}")
    out = {"phase": 25, "card": card, "levels": levels,
           "launches_per_match_pair": 2 * len(levels),
           **{f"{key}_per_match_pair": 2 * sum(lv[key] for lv in levels)
              for key in ("device_us", "event_us", "twin_us", "bound_us")},
           "bars": "kernel == twin on the card (torch.equal) for u8 and f32 "
                   "images; one counted launch and one kernel node a call",
           "timing": f"median of {reps} CUDA-event timings (50 kernel calls "
                     "or 5 twin calls back to back) after warm-up; device "
                     "times by the profiler"}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# MSER's ladder level areas (K7): it replaces no TPU kernel; the twin's run
# record chain was ~115 launches and a host read a changed level


def text_ladder_labels(f: torch.Tensor, config) -> list:
    """K2b's labels at each changed level of MSER's ladder on ``f``
    (dark mode), as mser_detect makes them."""
    from compv_tpu_torch.features.mser import ladder_levels
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck

    h, w = f.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=f.device).reshape(h, w)
    lbl = torch.full((h, w), -1, dtype=torch.int32, device=f.device)
    out = []
    for t in ladder_levels(config)[2]:
        fg = f <= t
        if bool((fg != (lbl >= 0)).any()):
            lbl = ck.ccl_label_seeded(fg, torch.where(lbl >= 0, lbl, idx))
            out.append(lbl)
    return out


def phase26_level_areas(dev, card: str, text: np.ndarray) -> dict:
    """K7 at the text scene's shapes: every changed level of its MSER
    ladder (1182 x 1122, mser_detect's amin and cap), each call against
    its twin on the card, exact, one launch counted and three kernel nodes
    (a captured graph's) a call, the scratch zero after the ladder; then
    device time a call (profiler) by kernel and by level, event time (CUDA
    events over the ladder's calls back to back), the twin's device time,
    device operations and event time a level, and the bound."""
    from compv_tpu_torch.features.mser import MserConfig
    from compv_tpu_torch.ops.kernels import level_areas as la

    cfg = MserConfig()
    f = torch.from_numpy(text).to(dev)
    labels = text_ladder_labels(f, cfg)
    h, w = text.shape
    n = h * w
    amin = max(int(cfg.min_area * n), 1)
    cap = min(cfg.max_candidates, h * la.run_tiers(h, w, cfg.run_tiers)[0])
    buf = la.scratch(n, dev)
    root = torch.empty((cap,), dtype=torch.int32, device=dev)
    area = torch.empty_like(root)
    over = torch.empty((), dtype=torch.int32, device=dev)
    found = []
    for k, lbl in enumerate(labels):
        before = la.launches
        la.level_candidates(lbl, amin, cap, root, area, over, buf)
        check(la.launches == before + 1, "K7 did not count its launch")
        want = la._level_candidates_ref(lbl, amin, cap, cfg.run_tiers)
        for name, got, x in zip(("root", "area", "over"), (root, area, over),
                                want):
            check(torch.equal(got, x.reshape(got.shape)),
                  f"level {k}: K7 != twin in {name}")
        found.append(int((root >= 0).sum()))
    check(not bool(buf[:n].any()), "K7 left its count table non-zero")

    def call(lbl=labels[-1]):
        la.level_candidates(lbl, amin, cap, root, area, over, buf)

    nodes = captured_nodes(call)
    check(nodes == [0, 0, 0], f"a K7 call issued {nodes}, not three kernels")

    def kernel_all():
        for lbl in labels:
            la.level_candidates(lbl, amin, cap, root, area, over, buf)

    def twin_all():
        for lbl in labels:
            la._level_candidates_ref(lbl, amin, cap, cfg.run_tiers)

    events = device_events(kernel_all)[0]
    by_kernel, per_level = {}, None
    for name, us in events:
        key = name.split("::")[-1].split("(")[0]
        by_kernel[key] = by_kernel.get(key, 0.0) + us / len(labels)
    if len(events) == 3 * len(labels):
        per_level = [sum(us for _, us in events[3 * k:3 * k + 3])
                     for k in range(len(labels))]
    twin_events = device_events(twin_all)[0]
    # bytes: the labels read once, the candidate table written once; the
    # count table's write and read back (8 B a pixel) stay in the L2.
    # Operations: about four int32 operations a pixel
    bnd = bound(4 * n + 8 * cap + 4, 4 * n, INT32_OPS_PER_S)
    reps = TIMING_REPS["orient"]
    out = {"phase": 26, "card": card, "shape": [h, w], "amin": amin,
           "cap": cap, "levels": len(labels),
           "candidates_per_level": found,
           "device_us": (sum(by_kernel.values()) if events else
                         device_ms(kernel_all, 1) * 1e3 / len(labels)),
           "device_us_by_kernel": by_kernel,
           "device_us_per_level": per_level,
           "event_us": cuda_ms(kernel_all, reps=reps) * 1e3 / len(labels),
           "twin_device_us": (sum(us for _, us in twin_events) / len(labels)
                              if twin_events else None),
           "twin_device_ops": (len(twin_events) / len(labels)
                               if twin_events else None),
           "twin_us": cuda_ms(twin_all, reps=3) * 1e3 / len(labels),
           "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"],
           "bound_with_table_us": (4 * n + 8 * n + 8 * cap + 4)
           / HBM_BYTES_PER_S * 1e6,
           "bars": "kernel == twin on the card (torch.equal: root, area, "
                   "over) on every changed level; one counted launch and "
                   "three kernel nodes a call; the scratch zero after",
           "timing": f"per call, mean over the {len(labels)} changed "
                     f"levels; event: median of {reps} CUDA-event timings "
                     "of the ladder's calls back to back, twin: of 3; "
                     "device times by the profiler"}
    check(out["bound_us"] <= out["device_us"],
          f"the K7 bound above its device time: {out}")
    emit(out)
    return out


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
    """Route labeling, compaction and the ladder's level areas through the
    twins (this phase only)."""
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk
    from compv_tpu_torch.ops.kernels import level_areas as la

    saved = ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows
    saved_areas = la.level_candidates

    def label(binary, connectivity=8, max_iterations=64):
        h, w = binary.shape
        idx = torch.arange(h * w, dtype=torch.int32,
                           device=binary.device).reshape(h, w)
        return ck.label_ref(binary > 0, idx, connectivity, max_iterations)

    def seeded(binary, init, connectivity=8, max_iterations=64):
        return ck.label_ref(binary > 0, init, connectivity, max_iterations)

    def candidates(lbl, amin, cap, root, area, over, buf=None,
                   tiers=(112, 320)):
        r, a, o = la._level_candidates_ref(lbl, amin, cap, tiers)
        root.copy_(r)
        area.copy_(a)
        over.copy_(o.reshape(over.shape))

    ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows = (
        label, seeded, cpk.compact_ref)
    la.level_candidates = candidates
    try:
        yield
    finally:
        ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows = saved
        la.level_candidates = saved_areas


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
    from compv_tpu_torch.ops.kernels import level_areas as la

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
    ck.ccl_label_seeded.launches = la.launches = 0
    mres = mser_detect(img, cfg)
    torch.cuda.synchronize()
    counts["K2b"] = ck.ccl_label_seeded.launches
    counts["K7"] = la.launches
    syncs = mser_mod.last_syncs
    check(counts["K2b"] == n_levels,
          f"K2b launches {counts['K2b']} != {n_levels} changed levels")
    check(counts["K7"] == n_levels,
          f"K7 launches {counts['K7']} != {n_levels} changed levels")
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
    # lists past a block's shared memory (min(rounds, strip pixels) >
    # 11,519): the kernel's form with its buffers in device memory
    per_pixel_wide = torch.arange(24 * 8192, dtype=torch.int32,
                                  device=dev).reshape(24, 8192)
    k5_maps += [("wide_8x8192_rounds_11520", wide, 11520),
                ("per_pixel_8x8192_rounds_11520", per_pixel_wide, 11520),
                ("per_pixel_8x8192_desc_rounds_65536",
                 per_pixel_wide.flip(1).contiguous(), 65536)]
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


# ---------------------------------------------------------------------------
# the SfM path: run_sfm (ORB on every frame through K1, essential bootstrap,
# PnP, triangulation, local and final BA), its components and its times


def load_golden(name: str) -> dict:
    with open(os.path.join(ROOT, "goldens", name)) as f:
        return json.load(f)


def np_rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation matrix of an axis-angle vector, in float64 numpy."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    km = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * km + (1 - np.cos(theta)) * (km @ km)


def ba_scene(f: int, l: int, o: int, seed: int = 17) -> dict:
    """A BA problem of ``f`` cameras, ``l`` landmarks and ``o``
    observations (random pairs, all in front of their camera): 0.5 px noise,
    2% of the pixels off by 25 px, cameras 2.. and every landmark perturbed;
    cameras 0 and 1 stay at the truth (pinned by the windowed solves)."""
    rs = np.random.default_rng(seed)
    cams = np.concatenate([rs.normal(0, 0.05, (f, 3)),
                           rs.normal(0, 0.4, (f, 3))], 1)
    lms = rs.uniform(-2, 2, (l, 3)) + [0, 0, 7.0]
    ci = rs.integers(0, f, o)
    li = rs.integers(0, l, o)
    rot = np.stack([np_rodrigues(c[:3]) for c in cams])
    pc = np.einsum("oij,oj->oi", rot[ci], lms[li]) + cams[ci, 3:]
    uv = 400.0 * pc[:, :2] / pc[:, 2:3] + [320.0, 240.0]
    uv += rs.normal(0, 0.5, uv.shape)
    uv[rs.random(o) < 0.02] += 25.0
    cams_n = cams + rs.normal(0, 0.005, cams.shape)
    cams_n[:2] = cams[:2]
    return {"cameras": cams_n.astype(np.float32),
            "landmarks": (lms + rs.normal(0, 0.02, lms.shape)
                          ).astype(np.float32),
            "intrinsics": np.array([400.0, 400.0, 320.0, 240.0], np.float32),
            "cam_idx": ci.astype(np.int32), "lm_idx": li.astype(np.int32),
            "uv": uv.astype(np.float32), "valid": np.ones(o, bool)}


def phase12_sfm_components(dev) -> dict:
    from compv_tpu_torch.calib import epipolar as te
    from compv_tpu_torch.calib import pnp as tp
    from compv_tpu_torch.calib.homography import _masked_sample_idx
    from compv_tpu_torch.core.golden import quantized_hash
    from compv_tpu_torch.interop import ba_problem_from_numpy
    from compv_tpu_torch.ops import threefry
    from compv_tpu_torch.slam import ba as tba
    from compv_tpu_torch.slam import ba_schur as tbs

    out = {}
    # find_essential: tests/test_epipolar.py's two-view scene, 45 of 150
    # correspondences replaced by random pixels, 1024 hypotheses
    rs = np.random.default_rng(1)
    k = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]],
                 np.float32)
    pts = rs.uniform(-1, 1, (150, 3)) + [0, 0, 4.0]
    r_true = np_rodrigues(np.array([0.05, -0.12, 0.03]))

    def proj(p):
        return p[:, :2] / p[:, 2:3] * 500.0 + [320.0, 240.0]

    p1 = proj(pts)
    p2 = proj(pts @ r_true.T + [0.4, 0.05, 0.02])
    bad = rs.choice(150, 45, replace=False)
    p2[bad] = rs.uniform(0, 640, (45, 2))
    args = [torch.from_numpy(a.astype(np.float32)) for a in (p1, p2)] + [
        torch.from_numpy(k), torch.ones(150, dtype=torch.bool)]
    cfg = te.EssentialConfig(num_hypotheses=1024)
    samples = [threefry.randint((0, 0), (1024, 8), 0,
                                torch.tensor(150, device=d), d).cpu()
               for d in (dev, "cpu")]
    check(torch.equal(*samples), "randint on the card != on the CPU")
    card = te.find_essential(*[a.to(dev) for a in args], cfg)
    cpu = te.find_essential(*args, cfg)
    check(torch.equal(card.inliers.cpu(), cpu.inliers),
          "find_essential inliers: card != CPU")
    e_c, e_h = card.e.cpu(), cpu.e
    e_err = min(float((e_c - e_h).abs().max()), float((e_c + e_h).abs().max()))
    pose_err = max(float((card.rvec.cpu() - cpu.rvec).abs().max()),
                   float((card.tvec.cpu() - cpu.tvec).abs().max()))
    check(e_err <= 2e-4 and pose_err <= 2e-4,
          f"find_essential: E {e_err}, pose {pose_err} from the CPU's")
    out["essential"] = {"inliers": int(card.num_inliers), "e_err": e_err,
                        "pose_err": pose_err}

    # solve_pnp: tests/test_sfm.py's pose scene, 20 of 64 points off by
    # 30-90 px, padded to 128
    rs = np.random.default_rng(3)
    kp = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    pts = rs.uniform(-2, 2, (64, 3)) + [0, 0, 6.0]
    pc = pts @ np_rodrigues(np.array([0.05, -0.1, 0.03])).T + [0.2, -0.1, 0.4]
    px = pc[:, :2] / pc[:, 2:3] * 400.0 + [160.0, 120.0]
    px[rs.choice(64, 20, replace=False)] += rs.uniform(30, 90, (20, 2))
    p3 = np.zeros((128, 3), np.float32)
    p2d = np.zeros((128, 2), np.float32)
    p3[:64], p2d[:64] = pts, px
    m = np.arange(128) < 64
    args = [torch.from_numpy(a) for a in (p3, p2d, kp, m)]
    idx = [_masked_sample_idx(0, args[3].to(d), 256, 6).cpu()
           for d in (dev, "cpu")]
    check(torch.equal(*idx), "PnP sample indices: card != CPU")
    card = tp.solve_pnp(*[a.to(dev) for a in args], tp.PnpConfig())
    cpu = tp.solve_pnp(*args, tp.PnpConfig())
    check(torch.equal(card.inliers.cpu(), cpu.inliers),
          "solve_pnp inliers: card != CPU")
    pose_err = max(float((card.rvec.cpu() - cpu.rvec).abs().max()),
                   float((card.tvec.cpu() - cpu.tvec).abs().max()))
    check(pose_err <= 1e-4, f"solve_pnp pose {pose_err} from the CPU's")
    out["pnp"] = {"inliers": int(card.num_inliers), "pose_err": pose_err}

    # ba_step on the golden BA problem (scripts/make_goldens.py:113-129)
    golden = load_golden("goldens.json")
    rs = np.random.default_rng(23)
    f, l, o = 16, 200, 1600
    cams = np.concatenate([rs.normal(0, 0.05, (f, 3)),
                           rs.normal(0, 0.5, (f, 3)) + [0, 0, 4]], 1)
    lms = rs.normal(0, 1.5, (l, 3)) + [0, 0, 8]
    gp = ba_problem_from_numpy({
        "cameras": cams, "landmarks": lms,
        "intrinsics": [400.0, 400.0, 240.0, 180.0],
        "cam_idx": rs.integers(0, f, o), "lm_idx": rs.integers(0, l, o),
        "uv": rs.normal(0, 40.0, (o, 2)) + 200,
        "valid": np.ones((o,), bool)}, dev)
    p1, _, cost = tba.ba_step(gp, torch.tensor(1e-3, device=dev),
                              tba.BAConfig(cg_iterations=8))
    got = {"ba_step_cost_before": round(float(cost), 1),
           "ba_step_cam_hash_q3": quantized_hash(p1.cameras, 3)}
    for name, value in got.items():
        check(value == golden[name], f"{name} {value} != {golden[name]}")
    out["ba_goldens"] = "met"

    # ba_solve / ba_solve_schur on a mid-size problem, cameras 0 and 1
    # pinned: card against CPU, and a second card run
    arrs = ba_scene(32, 4096, 32768)
    mask = np.arange(32) >= 2
    # landmarks of 1-3 observations are nearly free along their rays (the
    # damping alone holds them): compared are those seen 4 times or more
    seen = torch.from_numpy(np.bincount(arrs["lm_idx"], minlength=4096) >= 4)
    solves = {
        "ba_solve": lambda p, cm: tba.ba_solve(
            p, tba.BAConfig(iterations=8, cg_iterations=30,
                            robust_delta=3.0), cm),
        "ba_solve_schur": lambda p, cm: tbs.ba_solve_schur(
            p, tbs.SchurConfig(iterations=6, robust_delta=3.0), cm)}
    for name, solve in solves.items():
        runs = [solve(ba_problem_from_numpy(arrs, d),
                      torch.from_numpy(mask).to(d)) for d in (dev, dev, "cpu")]
        (a, ca), (b, cb), (h, ch) = runs
        check(torch.equal(a.cameras, b.cameras)
              and torch.equal(a.landmarks, b.landmarks)
              and torch.equal(ca, cb), f"{name}: two card runs differ")
        cost_rel = abs(float(ca) - float(ch)) / float(ch)
        cam_err = float((a.cameras.cpu() - h.cameras).abs().max())
        lm_err = float((a.landmarks.cpu() - h.landmarks)[seen].abs().max())
        out[name] = {"cost_card": float(ca), "cost_cpu": float(ch),
                     "cost_rel": cost_rel, "cam_err": cam_err,
                     "lm_err": lm_err, "landmarks_compared":
                     int(seen.sum()),
                     "rmse_before": float(tba.reproj_rmse(
                         ba_problem_from_numpy(arrs)))}
        check(cost_rel <= 1e-3 and cam_err <= 1e-3 and lm_err <= 1e-2,
              f"{name}: card vs CPU {out[name]}")
    torch.cuda.synchronize()
    emit({"phase": 12, **out,
          "tolerances": "E 2e-4 up to sign, essential pose 2e-4, PnP pose "
                        "1e-4; BA cost 1e-3 relative, cameras 1e-3, "
                        "landmarks seen 4 times or more 1e-2 (depth ~7)"})
    return out


def sfm_bars(ate: float, res, gt, golden: dict, what: str,
             span_pct: float = 3.0) -> dict:
    """The reference tests' bars (tests/test_sfm.py): ATE and RPE within 2x
    the golden, ATE under ``span_pct`` % of the trajectory's span, BA
    lowering the reprojection error to under 2.5 px."""
    from compv_tpu_torch.slam.evaluate import rpe_rmse

    rpe = float(rpe_rmse(torch.tensor(res.positions, dtype=torch.float32),
                         torch.tensor(gt, dtype=torch.float32)))
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    row = {"ate": ate, "golden_ate": golden["ate_rmse"], "rpe": rpe,
           "golden_rpe": golden["rpe_rmse"], "ate_pct_of_span":
           100 * ate / span, "reproj_before": res.reproj_before,
           "reproj_after": res.reproj_after, "num_tracks": res.num_tracks,
           "num_obs": res.num_obs}
    check(ate <= 2 * golden["ate_rmse"] and rpe <= 2 * golden["rpe_rmse"]
          and 100 * ate / span < span_pct
          and res.reproj_after < res.reproj_before
          and res.reproj_after < 2.5, f"{what} misses its bars: {row}")
    check(np.isfinite(res.positions).all() and res.positions.shape
          == (len(gt), 3), f"{what}: positions not finite or misshapen")
    return row


def sfm_128_config():
    """scripts/make_goldens.py:169-178: Schur solver, an 8-frame window,
    checkpoints every 16 frames, 131,072 observations, 16,384 landmarks."""
    from compv_tpu_torch.slam.sfm import SfmConfig

    return SfmConfig(solver="schur", local_window=8, checkpoint_every=16,
                     max_obs=131072, max_landmarks=16384)


def sfm_128_run(dev, resume: bool) -> dict:
    """goldens/sfm_128.json's run (Schur, an 8-frame window, checkpoints
    every 16 frames) held to its bars, and with ``resume`` then
    ``resume_sfm`` from its last checkpoint held to the resume bar. Also
    counts the Schur steps whose reduced system S failed to factor, and
    those where S held a non-finite entry (a waiting read of each step's
    factorization)."""
    from compv_tpu_torch.slam import sfm as ts
    from compv_tpu_torch.slam.evaluate import ate_rmse

    g = load_golden("sfm_128.json")
    seq = g["sequence"]
    frames, gt, k = ts.render_orbit_sequence(seq["n_frames"], seq["h"],
                                             seq["w"], device=dev)
    ckpt = os.path.join(ROOT, "build", "sfm_128_checkpoints")
    if os.path.isdir(ckpt):
        for name in os.listdir(ckpt):
            os.remove(os.path.join(ckpt, name))
    steps = {"schur_steps": 0, "s_not_factored": 0, "s_not_finite": 0}
    factor = torch.linalg.cholesky_ex

    def counted(a, **kwargs):
        fac = factor(a, **kwargs)
        steps["schur_steps"] += 1
        steps["s_not_factored"] += int(fac.info != 0)
        steps["s_not_finite"] += int(not torch.isfinite(a).all())
        return fac

    torch.linalg.cholesky_ex = counted
    try:
        t0 = time.perf_counter()
        res = ts.run_sfm(frames, k, sfm_128_config(), checkpoint_dir=ckpt,
                         device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        torch.linalg.cholesky_ex = factor

    def ate_of(r):
        return float(ate_rmse(torch.tensor(r.positions, dtype=torch.float32),
                              torch.tensor(gt, dtype=torch.float32)))

    # the mid-run trajectory, before the final BA: the last checkpoint's
    from compv_tpu_torch.io.serialize import load_checkpoint
    from compv_tpu_torch.slam.ba import rodrigues_to_matrix

    cams = load_checkpoint(os.path.join(ckpt, f"step_{seq['n_frames']}.pt"))[
        "cams"].to(torch.float32)
    centers = -(rodrigues_to_matrix(cams[:, :3]).mT
                @ cams[:, 3:, None])[:, :, 0]
    steps["ate_before_final_ba"] = float(ate_rmse(
        centers, torch.tensor(gt, dtype=torch.float32)))
    emit({"sfm_128_480p_schur": {"run_s": run_s, **steps}})
    ate = ate_of(res)
    out = {**sfm_bars(ate, res, gt, g, "sfm_128.json", span_pct=2.5),
           "run_s": run_s, **steps}
    if resume:
        check(steps["s_not_finite"] == 0,
              f"sfm_128: a Schur step's S held a non-finite entry: {steps}")
        names = sorted(os.listdir(ckpt))
        check(names == [f"step_{seq['n_frames']}.pt"],
              f"checkpoints written: {names}")
        resumed = ts.resume_sfm(os.path.join(ckpt, names[-1]),
                                sfm_128_config(), device=dev)
        span = float(np.linalg.norm(gt[-1] - gt[0]))
        ate_r = ate_of(resumed)
        check(ate_r <= max(1.5 * ate, 0.03 * span),
              f"resume_sfm ATE {ate_r} vs direct {ate}")
        out["resumed_ate"] = ate_r
    return out


def phase13_sfm_slice(dev) -> dict:
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.slam import sfm as ts

    out = {}
    # goldens/sfm.json: 8 frames at 240x320, the default config
    g = load_golden("sfm.json")["sequence"]
    frames, gt, k = ts.render_orbit_sequence(g["n_frames"], g["h"], g["w"],
                                             device=dev)
    torch.cuda.synchronize()
    fk.launches = 0
    ate, res = ts.sfm_ate(frames, gt, k, device=dev)
    torch.cuda.synchronize()
    out["sfm_8_240p"] = {**sfm_bars(ate, res, gt, load_golden("sfm.json"),
                                    "sfm.json"), "k1_launches": fk.launches}
    check(fk.launches == 4 * g["n_frames"],
          f"K1 launches {fk.launches} != 4 levels x {g['n_frames']} frames")

    # goldens/sfm_long.json: 32 frames at 480x640 (its second run, which
    # must be identical, is phase 14's profiled run)
    g = load_golden("sfm_long.json")
    seq = g["sequence"]
    cfg = ts.SfmConfig(max_obs=65536, max_landmarks=8192)
    frames, gt, k = ts.render_orbit_sequence(seq["n_frames"], seq["h"],
                                             seq["w"], device=dev)
    torch.cuda.synchronize()
    fk.launches = 0
    totals, captured = {}, {}       # its stage times: phase 14's readings
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with stage_timer(ts, totals, captured):
        start.record()
        ate, res = ts.sfm_ate(frames, gt, k, cfg, device=dev)
        end.record()
    torch.cuda.synchronize()
    totals["run_sfm"] = start.elapsed_time(end)
    k1_sfm = fk.launches
    check(k1_sfm == 4 * seq["n_frames"],
          f"K1 launches {k1_sfm} != 4 levels x {seq['n_frames']} frames")
    out["sfm_32_480p"] = {**sfm_bars(ate, res, gt, g, "sfm_long.json"),
                          "k1_launches": k1_sfm,
                          "second_run": "phase 14's profiled run"}
    sfm_long_result = res

    # goldens/sfm_128.json: the production-shaped run, then resume_sfm from
    # its last checkpoint
    out["sfm_128_480p_schur"] = sfm_128_run(dev, resume=True)

    # 6 frames at 120x160: the card against the port on the CPU
    frames, gt, k = ts.render_orbit_sequence(6, 120, 160, device=dev)
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    frames_cpu = ts.render_orbit_sequence(6, 120, 160, device="cpu")[0]
    check(np.array_equal(frames, frames_cpu), "render: card != CPU")
    cfg = ts.SfmConfig(max_obs=4096, max_landmarks=1024)
    calls = {}
    inner = ts.find_essential

    def rec(src, dst, kk, mask, config):
        res_e = inner(src, dst, kk, mask, config)
        calls[src.device.type] = (src.cpu(), dst.cpu(), res_e.inliers.cpu())
        return res_e

    ts.find_essential = rec
    try:
        ate_card, card = ts.sfm_ate(frames, gt, k, cfg, device=dev)
        ate_cpu, cpu = ts.sfm_ate(frames, gt, k, cfg, device="cpu")
    finally:
        ts.find_essential = inner
    check(card.num_tracks == cpu.num_tracks, "6-frame tracks: card != CPU")
    check(all(torch.equal(a, b) for a, b in zip(calls["cuda"], calls["cpu"])),
          "6-frame bootstrap pair or essential inliers: card != CPU")
    check(ate_card <= max(1.5 * ate_cpu, 0.03 * span),
          f"6-frame ATE {ate_card} on the card vs {ate_cpu} on the CPU")
    out["sfm_6_120p_card_vs_cpu"] = {
        "tracks": card.num_tracks, "essential_inliers":
        int(calls["cpu"][2].sum()), "ate_card": ate_card, "ate_cpu": ate_cpu}
    emit({"phase": 13, **out,
          "bars": "ATE, RPE <= 2x golden; ATE < 3% of span (2.5% at 128 "
                  "frames); reproj after < before and < 2.5 px; resume "
                  "ATE <= max(1.5x direct, 3% of span); 6-frame ATE on the "
                  "card <= max(1.5x the CPU's, 3% of span)"})
    out["sfm_32_480p_run"] = (sfm_long_result, totals, captured)  # phase 14
    return out


STAGES = {"orb_detect_describe": "frontend_orb",
          "_match_step": "frontend_match", "find_essential": "essential",
          "solve_pnp": "pnp", "_triangulate_pair": "triangulation",
          "_solve": "local_ba", "_finalize_sfm": "final_ba"}


@contextlib.contextmanager
def stage_timer(ts, totals: dict, captured: dict):
    """Wrap run_sfm's stages with CUDA events (summed per stage into
    ``totals`` after the run); a BA inside _finalize_sfm counts as the
    final BA; the first problem the final BA solves is kept in
    ``captured``."""
    saved = {name: getattr(ts, name) for name in STAGES}
    marks = []
    inside = []

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if name == "_solve" and inside:
                captured.setdefault("final_problem", args[0])
                return fn(*args, **kwargs)
            if name == "_finalize_sfm":
                inside.append(True)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                marks.append((STAGES[name], start, end))
                if name == "_finalize_sfm":
                    inside.clear()
        return timed

    for name, fn in saved.items():
        setattr(ts, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ts, name, fn)
        torch.cuda.synchronize()
        for stage, start, end in marks:
            totals[stage] = totals.get(stage, 0.0) + start.elapsed_time(end)


def same_sfm_run(a, b, what: str) -> None:
    """Two run_sfm results of one sequence and config, bit-identical."""
    for name in ("positions", "cameras", "landmarks", "landmark_valid"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"{what} differs in {name}")
    check(a.frame_stats == b.frame_stats, f"{what} differs in frame_stats")


def phase14_sfm_times(dev, card: str, first_run) -> dict:
    """``first_run``: phase 13's sfm_long run, its stage times and the
    final BA's problem."""
    from compv_tpu_torch.slam import ba as tba
    from compv_tpu_torch.slam import ba_schur as tbs
    from compv_tpu_torch.slam import sfm as ts

    g = load_golden("sfm_long.json")["sequence"]
    n = g["n_frames"]
    cfg = ts.SfmConfig(max_obs=65536, max_landmarks=8192)
    frames, gt, k = ts.render_orbit_sequence(n, g["h"], g["w"], device=dev)
    first, totals, captured = first_run
    per_frame = {stage: ms / n for stage, ms in totals.items()}
    other = per_frame["run_sfm"] - sum(v for s, v in per_frame.items()
                                       if s != "run_sfm")

    # one ba_solve and one ba_solve_schur at the final BA's shape
    prob = captured["final_problem"]
    ba_ms = cuda_ms(lambda: tba.ba_solve(prob, cfg.ba),
                    reps=TIMING_REPS["sfm_ba"])
    schur_ms = cuda_ms(lambda: tbs.ba_solve_schur(prob, tbs.SchurConfig(
        iterations=cfg.ba.iterations, damping=cfg.ba.damping,
        robust_delta=cfg.ba.robust_delta)), reps=TIMING_REPS["sfm_ba"])

    # device busy, idle share and launches per frame under torch.profiler
    wall_ms = per_frame["run_sfm"] * n
    profiled = []
    events, prof_wall = device_events(lambda: profiled.append(ts.run_sfm(
        frames, k, cfg, device=dev)), warm=False)
    if not profiled:                # --no-profiler: no window ran it
        profiled.append(ts.run_sfm(frames, k, cfg, device=dev))
    # phase 13's sfm_long run again: a second card run, identical
    same_sfm_run(first, profiled[-1], "sfm_long: a second card run")
    kernels = [e for e in events if not e[0].startswith("Memcpy")
               and not e[0].startswith("Memset")]
    busy_ms = sum(us for _, us in events) / 1e3
    prof = ({"busy_ms_per_frame": busy_ms / n,
             "idle_share": 1 - busy_ms / wall_ms,
             "kernel_launches_per_frame": len(kernels) / n,
             "device_ops_per_frame": len(events) / n,
             "profiled_wall_ms_per_frame": prof_wall / n}
            if events else {"busy_ms_per_frame": None, "idle_share": None,
                            "kernel_launches_per_frame": None})
    if not events:
        PROFILER["fallbacks"] += 1
    out = {"ms_per_frame": per_frame, "other_host_ms_per_frame": other,
           "final_ba_shape": {"cameras": int(prob.cameras.shape[0]),
                              "landmarks": int(prob.landmarks.shape[0]),
                              "obs_slots": int(prob.cam_idx.shape[0]),
                              "obs_valid": int(prob.valid.sum())},
           "ba_solve_ms": ba_ms, "ba_solve_schur_ms": schur_ms,
           "profile": prof}
    emit({"phase": 14, "card": card, "at": "sfm_long (32 frames, 480x640)",
          **out, "timing": "CUDA events around each stage of phase 13's "
          "sfm_long run; BA solves: median of "
          f"{TIMING_REPS['sfm_ba']} CUDA-event timing(s) after warm-up; the "
          "profiled run is identical to phase 13's"})
    return out


# ---------------------------------------------------------------------------
# slice 3: calibration from images (find_chessboard_corners through K4 on
# every view, Zhang + LM, undistortion), planar tracking (ORB through K1 on
# every level of every frame), the pose graph, RANSAC and fits, and the
# leftovers of slices 1-2


# K of the calibration views: 720 x 1280 at f = 1000
CAL_K = np.array([[1000.0, 0.0, 640.0], [0.0, 1000.0, 360.0],
                  [0.0, 0.0, 1.0]])
# final / initial cost of the reference (compv_tpu, JAX 0.9.0 on a CPU) on
# sphere_graph() with PoseGraphConfig(): scripts/posegraph_sphere_reference.py
POSEGRAPH_REF_RATIO = 0.017327983514009965
# the reference's classifier path (compv_tpu, JAX 0.9.0 on a CPU) on the
# windows of hog_windows(): windows right of 11,475 with the RBF and the
# linear SVM and the 5-NN vote in PCA space, the smallest RBF |decision|,
# the PCA's largest and 64th eigenvalue: scripts/hog_svm_reference.py
HOG_SVM_REF = {"windows": 11475, "rbf_correct": 11471,
               "linear_correct": 11455, "knn5_correct": 11449,
               "rbf_min_abs_decision": 0.0032, "pca_eig_first": 7.773,
               "pca_eig_64th": 0.0236}
# a window of the classifier path: 128 x 64 pixels, 15 x 7 HOG blocks
HOG_WINDOW_BLOCKS = (15, 7)
HOG_TRAIN = 2048


def hog_windows(desc: torch.Tensor) -> torch.Tensor:
    """Every 128 x 64 window of a dense HOG descriptor (n_by, n_bx, 36) at a
    one-cell stride, row-major: (windows, 15 * 7 * 36), each window its
    blocks in row-major order."""
    by, bx = HOG_WINDOW_BLOCKS
    w = desc.unfold(0, by, 1).unfold(1, bx, 1)      # (ny, nx, 36, by, bx)
    return w.permute(0, 1, 3, 4, 2).reshape(-1, by * bx * desc.shape[2])


def hog_window_labels(desc_shape, cell: int = 8) -> np.ndarray:
    """+1 where a window's centre lies inside bench.py's checkerboard patch
    (x 300-1000, y 150-570, bench.py:46), else -1, float32."""
    by, bx = HOG_WINDOW_BLOCKS
    ny, nx = desc_shape[0] - by + 1, desc_shape[1] - bx + 1
    cy = np.arange(ny)[:, None] * cell + (by + 1) * cell // 2
    cx = np.arange(nx)[None, :] * cell + (bx + 1) * cell // 2
    inside = (cx > 300) & (cx < 1000) & (cy > 150) & (cy < 570)
    return np.where(inside, 1.0, -1.0).astype(np.float32).reshape(-1)


def hog_train_index(n: int) -> np.ndarray:
    """The training windows: HOG_TRAIN of n drawn by numpy seed 0."""
    return np.random.default_rng(0).choice(n, HOG_TRAIN, replace=False)


def knn_vote(neighbour_labels: torch.Tensor) -> torch.Tensor:
    """Majority of an odd number of +-1 labels per row."""
    return torch.where(neighbour_labels.sum(dim=1) >= 0, 1.0, -1.0)


def calibration_views(dev, n_views: int = 8):
    """``n_views`` views of 720x1280 of the 6x8 board of 80-px squares
    (phase 10's render, upright), each warped by the homography that takes
    the render's corners to the board seen through CAL_K at a known pose
    (as tests/test_checkerboard.py:97-120 builds 4 views at 500x660): a
    tilt of 0.3 rad about one of 8 axes in the image plane, a roll of up to
    0.175 rad, 2600 units away (squares of ~31 px), the grid's centre seen
    at (400, 240). The reference's corner finder (ported unchanged) finds
    from 1 to 7 of such 8 boards at this size, by where they sit and how
    they tilt, and calls some boards 30-60 px off valid
    (scripts/corner_views_probe.py); at this geometry it finds 7, each
    within 2 px. Returns (object points (48, 3), views (P, 720, 1280) u8,
    true corners (P, 48, 2)), all on ``dev``."""
    from compv_tpu_torch.calib.camera import checkerboard_object_points
    from compv_tpu_torch.calib.homography import compute_homography_dlt
    from compv_tpu_torch.calib.utils import project_points_dist
    from compv_tpu_torch.image.remap import warp_perspective

    rows, cols, square = 6, 8, 80.0
    board, corners = render_board(square=80, margin=80)
    board_t = torch.from_numpy(board).to(dev)
    corners_t = torch.as_tensor(corners, dtype=torch.float32, device=dev)
    k = torch.as_tensor(CAL_K, dtype=torch.float32, device=dev)
    obj = checkerboard_object_points(rows, cols, square, device=dev)
    no_dist = torch.zeros(4, device=dev)
    z = 2600.0
    # the grid's centre, (280, 200) in board units, seen at (400, 240)
    tvec = torch.tensor([(400 - CAL_K[0, 2]) * z / CAL_K[0, 0] - 280.0,
                         (240 - CAL_K[1, 2]) * z / CAL_K[1, 1] - 200.0, z],
                        dtype=torch.float32, device=dev)
    views, truth = [], []
    for i in range(n_views):
        a = 2 * np.pi * i / n_views
        rvec = torch.tensor([0.3 * np.cos(a), 0.3 * np.sin(a),
                             0.05 * (i - 3.5)], dtype=torch.float32,
                            device=dev)
        proj = project_points_dist(obj, k, no_dist, rvec, tvec)
        h = compute_homography_dlt(corners_t, proj)
        views.append(warp_perspective(board_t, torch.linalg.inv(h), 720, 1280,
                                      fill=128.0))
        truth.append(proj)
    return obj, torch.stack(views), torch.stack(truth)


def planar_truth(t: int, h: int, w: int) -> np.ndarray:
    """Frame 0 -> frame t: a turn of 0.3 degrees x t about the image
    centre, then a shift of (4t, 2t) px."""
    th = np.deg2rad(0.3 * t)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    turn = np.array([[np.cos(th), -np.sin(th), 0.0],
                     [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    to_c = np.array([[1.0, 0.0, cx], [0.0, 1.0, cy], [0.0, 0.0, 1.0]])
    from_c = np.array([[1.0, 0.0, -cx], [0.0, 1.0, -cy], [0.0, 0.0, 1.0]])
    shift = np.array([[1.0, 0.0, 4.0 * t], [0.0, 1.0, 2.0 * t],
                      [0.0, 0.0, 1.0]])
    return shift @ to_c @ turn @ from_c


def planar_frames(dev, scene: np.ndarray, n: int = 16):
    """The 720x1282 bench scene warped by planar_truth(t), t < n, fill 128,
    on ``dev``."""
    from compv_tpu_torch.image.remap import warp_perspective

    img = torch.from_numpy(scene).to(dev)
    h, w = scene.shape
    return [warp_perspective(img, torch.as_tensor(
        np.linalg.inv(planar_truth(t, h, w)), dtype=torch.float32,
        device=dev), h, w, fill=128.0) for t in range(n)]


def sphere_graph(rings: int = 50, per_ring: int = 50, seed: int = 0,
                 rot_sigma: float = 0.02, t_sigma: float = 0.05):
    """A pose graph of the size of g2o's sphere2500 (2,500 poses, 4,949
    edges), made from a seed: ``rings`` rings of ``per_ring`` poses on the
    unit sphere along one spiral, each pose turned by its azimuth and polar
    angle; ``rings * per_ring - 1`` odometry edges along the spiral and
    ``(rings - 1) * per_ring`` edges between neighbouring rings, each
    measurement the true relative pose with its rotation turned by a normal
    axis-angle of ``rot_sigma`` rad and ``t_sigma`` (units of the radius)
    added to its translation, weight 1. The poses start from the odometry
    chained from the true first pose. Returns (the graph as a dict of numpy
    arrays, the true poses (N, 6))."""
    from scipy.spatial.transform import Rotation

    rs = np.random.default_rng(seed)
    n = rings * per_ring
    rot = np.zeros((n, 3, 3))
    pos = np.zeros((n, 3))
    for r in range(rings):
        th = np.pi * (r + 0.5) / rings
        for i in range(per_ring):
            ph = 2 * np.pi * (i + r / rings) / per_ring
            k = r * per_ring + i
            pos[k] = [np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                      np.cos(th)]
            rot[k] = Rotation.from_euler("zy", [ph, th]).as_matrix()
    pairs = ([(k, k + 1) for k in range(n - 1)]
             + [(r * per_ring + i, (r + 1) * per_ring + i)
                for r in range(rings - 1) for i in range(per_ring)])
    meas = np.zeros((len(pairs), 6))
    for e, (i, j) in enumerate(pairs):
        r_rel = rot[i].T @ rot[j] @ Rotation.from_rotvec(
            rs.normal(0, rot_sigma, 3)).as_matrix()
        meas[e, :3] = Rotation.from_matrix(r_rel).as_rotvec()
        meas[e, 3:] = rot[i].T @ (pos[j] - pos[i]) + rs.normal(0, t_sigma, 3)
    init_r, init_t = np.zeros((n, 3, 3)), np.zeros((n, 3))
    init_r[0], init_t[0] = rot[0], pos[0]
    for k in range(n - 1):
        init_t[k + 1] = init_r[k] @ meas[k, 3:] + init_t[k]
        init_r[k + 1] = init_r[k] @ Rotation.from_rotvec(meas[k, :3]
                                                         ).as_matrix()
    e = np.asarray(pairs)

    def poses(r, t):
        return np.concatenate([Rotation.from_matrix(r).as_rotvec(), t],
                              1).astype(np.float32)

    graph = {"poses": poses(init_r, init_t),
             "edge_i": e[:, 0].astype(np.int32),
             "edge_j": e[:, 1].astype(np.int32),
             "edge_meas": meas.astype(np.float32),
             "edge_weight": np.ones(len(pairs), np.float32),
             "edge_valid": np.ones(len(pairs), bool)}
    return graph, poses(rot, pos)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (b the CPU's)."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.detach().cpu().contiguous().view(torch.int32).long()
    b = b.detach().cpu().contiguous().view(torch.int32).long()
    return int((a - b).abs().max())


def phase15_slice3(dev, scene: np.ndarray) -> dict:
    from compv_tpu_torch.calib.camera import (CalibrationConfig,
                                              calibrate_camera)
    from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                    find_chessboard_corners)
    from compv_tpu_torch.calib.utils import undistort_image, undistort_points
    from compv_tpu_torch.features.orb import orb_detect_describe
    from compv_tpu_torch.interop import pose_graph_from_numpy
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.slam.pipeline import (KeyframeStore,
                                               PlanarTrackerConfig,
                                               decompose_homography,
                                               track_planar_sequence)
    from compv_tpu_torch.slam.posegraph import (PoseGraphConfig,
                                                graph_residuals,
                                                optimize_pose_graph)

    out = {}
    # A: calibration from images, 8 views of 720x1280
    obj, views, truth = calibration_views(dev)
    torch.cuda.synchronize()
    fk.launches = 0
    hk.sht_accumulate.launches = 0
    found = [find_chessboard_corners(v, CheckerboardConfig()) for v in views]
    ok = [bool(f.valid) for f in found]
    img_pts = torch.stack([f.corners for f, v in zip(found, ok) if v])
    cres = calibrate_camera(obj, img_pts, CalibrationConfig())
    und = undistort_image(views[0], cres.k, cres.dist)
    und_pts = undistort_points(img_pts[0], cres.k, cres.dist)
    torch.cuda.synchronize()
    k4_cal, k1_cal = hk.sht_accumulate.launches, fk.launches
    check(k4_cal == len(views) and k1_cal == 0,
          f"calibration: K4 launches {k4_cal} != {len(views)} views, "
          f"K1 {k1_cal} != 0")
    check(sum(ok) >= 6, f"{sum(ok)} of {len(views)} boards detected")
    k = cres.k.cpu().double().numpy()
    rms, rms0 = float(cres.rms), float(cres.rms_initial)
    f_err = max(abs(k[0, 0] - CAL_K[0, 0]), abs(k[1, 1] - CAL_K[1, 1])
                ) / CAL_K[0, 0]
    check(f_err < 0.15 and rms < 5.0,
          f"calibration: fx, fy {k[0, 0]}, {k[1, 1]}, RMS {rms}")
    check(rms <= rms0 + 1e-6, f"RMS after LM {rms} > before {rms0}")
    sel = torch.tensor(ok, device=dev)
    corner_err = float((img_pts - truth[sel]).abs().max())
    # a board called valid must be where it is: the reference's finder
    # calls some tilted boards valid 30-55 px off (ROADMAP Queue 3)
    check(corner_err <= 2.0,
          f"a detected board's corners are {corner_err} px from the truth")
    with hough_twins():
        twin = find_chessboard_corners(views[0], CheckerboardConfig())
    check(torch.equal(twin.corners, found[0].corners),
          "corners: kernel vs twin path")
    cpu = calibrate_camera(obj.cpu(), img_pts.cpu(), CalibrationConfig())
    k_rel = rel_err(cres.k, cpu.k)
    rms_rel = abs(rms - float(cpu.rms)) / float(cpu.rms)
    check(k_rel <= 1e-3 and rms_rel <= 1e-3,
          f"calibration card vs CPU: K {k_rel}, RMS {rms_rel} relative")
    und_cpu = undistort_image(views[0].cpu(), cres.k.cpu(), cres.dist.cpu())
    und_diff = int((und.cpu().int() - und_cpu.int()).abs().max())
    pts_diff = float((und_pts.cpu() - undistort_points(
        img_pts[0].cpu(), cres.k.cpu(), cres.dist.cpu())).abs().max())
    check(und_diff <= 1 and pts_diff <= 1e-2,
          f"undistortion card vs CPU: {und_diff} levels, {pts_diff} px")
    out["calibration_8x720p"] = {
        "views_detected": sum(ok), "k4_launches": k4_cal,
        "k1_launches": k1_cal, "fx": k[0, 0], "fy": k[1, 1],
        "cx": k[0, 2], "cy": k[1, 2], "dist": cres.dist.tolist(),
        "rms_initial_px": rms0, "rms_px": rms,
        "corner_err_px": corner_err, "k_rel_vs_cpu": k_rel,
        "rms_rel_vs_cpu": rms_rel, "undistort_image_max_diff_vs_cpu": und_diff,
        "undistort_points_max_diff_px_vs_cpu": pts_diff}

    # B: planar tracking, PLANAR_FRAMES frames of the 720x1282 scene
    frames = planar_frames(dev, scene, PLANAR_FRAMES)
    h, w = scene.shape
    cfg = PlanarTrackerConfig()
    torch.cuda.synchronize()
    fk.launches = 0
    hk.sht_accumulate.launches = 0
    track = track_planar_sequence(frames, cfg)
    torch.cuda.synchronize()
    k1_track, k4_track = fk.launches, hk.sht_accumulate.launches
    check(k1_track == cfg.orb.levels * len(frames) and k4_track == 0,
          f"track: K1 launches {k1_track} != {cfg.orb.levels} levels x "
          f"{len(frames)} frames, K4 {k4_track}")
    check(all(track.tracked), f"frames lost: {track.tracked}")
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                        [w - 1, h - 1, 1]], np.float64).T

    def corner_px(hm, t):
        a = hm @ corners
        b = planar_truth(t, h, w) @ corners
        return float(np.abs(a[:2] / a[2] - b[:2] / b[2]).max())

    errs = [corner_px(hm, t) for t, hm in enumerate(track.h_to_first)]
    check(max(errs) <= 2.0, f"chained H off by {max(errs)} px")
    track_cpu = track_planar_sequence([f.cpu() for f in frames], cfg)
    errs_cpu = [corner_px(hm, t) for t, hm in enumerate(track_cpu.h_to_first)]
    k_t = torch.as_tensor(CAL_K, dtype=torch.float32, device=dev)
    h_last = torch.as_tensor(track.h_to_first[-1], dtype=torch.float32,
                             device=dev)
    dec = decompose_homography(h_last, k_t)
    dec_cpu = decompose_homography(h_last.cpu(), k_t.cpu())
    dec_err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(dec, dec_cpu))
    check(dec_err <= 1e-4, f"decompose_homography card vs CPU {dec_err}")
    store = KeyframeStore(capacity=2)
    for t in (0, len(frames) - 1):
        store.add(t, orb_detect_describe(frames[t], cfg.orb), np.eye(4))
    desc, valid = store.stacked_descriptors()
    check(desc.shape == (2, cfg.orb.max_features, 256),
          "keyframe store shape")
    out["planar_track_720p"] = {
        "frames": len(frames), "k1_launches": k1_track,
        "k4_launches": k4_track, "tracked": all(track.tracked),
        "inliers_card": track.num_inliers, "inliers_cpu": track_cpu.num_inliers,
        "tracked_cpu": all(track_cpu.tracked),
        "corner_err_px_max": max(errs), "corner_err_px_max_cpu": max(errs_cpu),
        "corner_err_px_last": errs[-1],
        "decompose_rvec": dec[0].tolist(), "decompose_max_diff_vs_cpu": dec_err,
        "keyframes": len(store)}

    # C: the pose graph at sphere2500's size
    g_np, true = sphere_graph()
    graph = pose_graph_from_numpy(g_np, dev)
    pcfg = PoseGraphConfig()
    cost_init = float((graph_residuals(graph.poses, graph) ** 2).sum())
    cost_true = float((graph_residuals(torch.from_numpy(true).to(dev), graph)
                       ** 2).sum())
    g1, c1 = optimize_pose_graph(graph, pcfg)
    g2, c2 = optimize_pose_graph(graph, pcfg)
    torch.cuda.synchronize()
    check(torch.equal(g1.poses, g2.poses) and torch.equal(c1, c2),
          "pose graph: a second card run differs")
    gc, cc = optimize_pose_graph(pose_graph_from_numpy(g_np), pcfg)
    ratio = float(c1) / cost_init
    check(ratio <= 1.5 * POSEGRAPH_REF_RATIO,
          f"pose graph cost ratio {ratio} > 1.5 x the reference's "
          f"{POSEGRAPH_REF_RATIO}")
    pg_rel = abs(float(c1) - float(cc)) / float(cc)
    check(pg_rel <= 1e-3, f"pose graph card vs CPU cost {pg_rel} relative")
    t_err = float((g1.poses[:, 3:].cpu() - torch.from_numpy(true[:, 3:]))
                  .abs().mean())
    out["posegraph_sphere2500"] = {
        "poses": int(graph.poses.shape[0]),
        "edges": int(graph.edge_i.shape[0]), "cost_initial": cost_init,
        "cost_final": float(c1), "cost_final_cpu": float(cc),
        "cost_at_truth": cost_true, "cost_ratio": ratio,
        "reference_cost_ratio": POSEGRAPH_REF_RATIO,
        "cost_rel_vs_cpu": pg_rel, "second_run": "identical",
        "translation_err_initial": float(np.abs(g_np["poses"][:, 3:]
                                                - true[:, 3:]).mean()),
        "translation_err_final": t_err}

    out["ransac_fits_65536"] = ransac_and_fits(dev)
    out["leftovers"] = leftovers_card_vs_cpu(dev, scene)
    emit({"phase": 15, **out,
          "bars": "calibration: >= 6 of 8 boards, fx and fy within 15 %, "
                  "RMS < 5 px and not above the closed form's, K and RMS "
                  "within 1e-3 of the CPU on the same corners; tracking: "
                  "every frame tracked, image corners within 2 px of the "
                  "truth; pose graph: final / initial cost <= 1.5x the "
                  "reference's, cost within 1e-3 of the CPU, two card runs "
                  "identical; fits: the line's inliers equal the CPU's"})
    return {"k4_per_calibration": k4_cal, "k1_per_track": k1_track,
            "obj": obj, "views": views, "img_pts": img_pts, "cres": cres,
            "frames": frames, "graph": graph}


def ransac_and_fits(dev) -> dict:
    """fit_line, fit_parabola (through the generic ransac) and the
    distances on 65,536 points, 30 % of them outliers, card against
    CPU."""
    from compv_tpu_torch.math.distance import (dist_line, dist_parabola,
                                               hamming, hamming_packed, l2,
                                               squared_l2)
    from compv_tpu_torch.math.fit import fit_line, fit_parabola

    rs = np.random.default_rng(15)
    n = 65536
    out = rs.random(n) < 0.3
    x = rs.uniform(0, 1000, n)
    y = 0.7 * x + 3 + rs.normal(0, 0.3, n)
    y[out] = rs.uniform(-300, 1000, int(out.sum()))
    pts = torch.as_tensor(np.stack([x, y], 1), dtype=torch.float32)
    line = fit_line(pts.to(dev), threshold=1.0)
    line_cpu = fit_line(pts, threshold=1.0)
    check(torch.equal(line.inliers.cpu(), line_cpu.inliers),
          "fit_line: card inliers != CPU")
    a, b, _ = line.abc.tolist()
    check(abs(-a / b - 0.7) < 0.01, f"fit_line slope {-a / b}")
    xp = rs.uniform(-10, 10, n)
    yp = 0.3 * xp ** 2 - 2 * xp + 5 + rs.normal(0, 0.1, n)
    yp[out] = rs.uniform(0, 60, int(out.sum()))
    pp = torch.as_tensor(np.stack([xp, yp], 1), dtype=torch.float32)
    par = fit_parabola(pp.to(dev), threshold=0.8)
    par_cpu = fit_parabola(pp, threshold=0.8)
    check(abs(float(par.abc[0]) - 0.3) < 0.01, f"parabola {par.abc.tolist()}")
    # the card's lstsq is QR (gels) of the tall, full-rank inlier system
    par_rel = rel_err(par.abc, par_cpu.abc)
    check(par_rel <= 1e-3, f"fit_parabola card vs CPU {par_rel} relative")
    d_line = dist_line(pts.to(dev), *line.abc.unbind())
    d_par = rel_err(dist_parabola(pp.to(dev), *par.abc.unbind()),
                    dist_parabola(pp, *par.abc.cpu().unbind()))
    check(d_par <= 1e-5, f"dist_parabola card vs CPU {d_par}")
    desc = torch.from_numpy(rs.integers(0, 256, (n, 32), dtype=np.uint8))
    ham = hamming_packed(desc.to(dev), desc[0].to(dev))
    check(torch.equal(ham.cpu(), hamming_packed(desc, desc[0])),
          "hamming_packed card != CPU")
    bits = torch.from_numpy(rs.integers(0, 2, (n, 256), dtype=np.uint8))
    check(torch.equal(hamming(bits.to(dev), bits[0].to(dev)).cpu(),
                      hamming(bits, bits[0])), "hamming card != CPU")
    q = torch.from_numpy(rs.normal(0, 1, (4096, 64)).astype(np.float32))
    sq_card, sq_cpu = squared_l2(q.to(dev), q[:512].to(dev)), squared_l2(
        q, q[:512])
    l2_rel = rel_err(sq_card, sq_cpu)
    check(l2_rel <= 1e-5, f"squared_l2 card vs CPU {l2_rel}")
    # |sqrt(a) - sqrt(b)| <= sqrt(|a - b|): the bound on the squares
    # carries to l2, whose near-zero entries (each row against itself,
    # where the expansion cancels) move most
    l2_diff = float((l2(q.to(dev), q[:512].to(dev)).cpu()
                     - l2(q, q[:512])).abs().max())
    l2_bound = (1e-5 * float(sq_cpu.abs().max())) ** 0.5
    check(l2_diff <= l2_bound, f"l2 card vs CPU {l2_diff} > {l2_bound}")
    return {"points": n, "outliers": int(out.sum()),
            "line_inliers": int(line.num_inliers),
            "line_inliers_equal_cpu": True, "line_abc": line.abc.tolist(),
            "parabola_inliers": int(par.num_inliers),
            "parabola_inliers_cpu": int(par_cpu.num_inliers),
            "parabola_inliers_equal_cpu": bool(torch.equal(
                par.inliers.cpu(), par_cpu.inliers)),
            "parabola_abc": par.abc.tolist(),
            "parabola_abc_rel_vs_cpu": par_rel,
            "dist_line_finite": bool(torch.isfinite(d_line).all()),
            "dist_parabola_rel_vs_cpu": d_par, "hamming": "exact",
            "squared_l2_rel_vs_cpu": l2_rel, "l2_max_diff_vs_cpu": l2_diff,
            "l2_bound": l2_bound}


def leftovers_card_vs_cpu(dev, scene: np.ndarray) -> dict:
    """The slice-1/2 leftovers on the card against the CPU: exact where
    the arithmetic is integer or the same f32 operations in the same order,
    else within the stated bound."""
    from compv_tpu_torch.image.pyramid import build_pyramid
    from compv_tpu_torch.image.scale import (rotate_bilinear, rotate_fast,
                                             scale_bicubic, scale_nearest)
    from compv_tpu_torch.math.stats import masked_variance, mse_2d
    from compv_tpu_torch.ops import threefry
    from compv_tpu_torch.ops.bitops import bits_xor, popcount_bytes
    from compv_tpu_torch.ops.conv import (convolve2d, convolve_separable,
                                          gaussian_blur_q16, gaussian_kernel1d,
                                          gaussian_kernel2d)

    gray = torch.from_numpy(scene)
    g = gray.to(dev)
    res = {}

    def exact(name, fn, *args):
        a = fn(*[x.to(dev) if isinstance(x, torch.Tensor) else x
                 for x in args])
        b = fn(*args)
        check(torch.equal(a.cpu(), b), f"{name}: card != CPU")
        res[name] = "exact"

    exact("gaussian_blur_q16", gaussian_blur_q16, gray)
    exact("scale_nearest", scale_nearest, gray, 500, 901)
    exact("scale_bicubic", scale_bicubic, gray, 500, 901)
    exact("convolve2d_5x5", convolve2d, gray, gaussian_kernel2d(5, 1.5))
    rb = (rotate_bilinear(g, 17.0).cpu().int()
          - rotate_bilinear(gray, 17.0).int()).abs()
    check(int(rb.max()) <= 1, f"rotate_bilinear card vs CPU {int(rb.max())}")
    res["rotate_bilinear_pixels_off_by_1"] = int((rb > 0).sum())
    rf = (rotate_fast(g, 17.0).cpu() - rotate_fast(gray, 17.0)).abs()
    check(float(rf.max()) <= 1e-2, f"rotate_fast card vs CPU {rf.max()}")
    res["rotate_fast_max_diff"] = float(rf.max())
    res["rotate_fast_values_differing"] = int((rf > 0).sum())
    wide = gaussian_kernel1d(41, 6.0)
    c41 = rel_err(convolve_separable(g, wide, wide),
                  convolve_separable(gray, wide, wide))
    c9 = rel_err(convolve2d(g, gaussian_kernel2d(9, 2.0)),
                 convolve2d(gray, gaussian_kernel2d(9, 2.0)))
    check(c41 <= 1e-5 and c9 <= 1e-5,
          f"library convolutions card vs CPU {c41}, {c9}")
    res["convolve_separable_41_taps_rel"] = c41
    res["convolve2d_9x9_rel"] = c9
    pyr = build_pyramid(g, 4, 0.83, "bicubic")
    pyr_cpu = build_pyramid(gray, 4, 0.83, "bicubic")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(pyr.images,
                                                      pyr_cpu.images)),
          "build_pyramid card != CPU")
    res["build_pyramid_bicubic"] = "exact"
    packed = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4096, 32), dtype=np.uint8))
    exact("popcount_bytes", popcount_bytes, packed)
    exact("bits_xor", bits_xor, packed, packed.flip(0))
    key = threefry.prng_key(7)
    nu = ulps(threefry.normal(key, (512, 512), dev),
              threefry.normal(key, (512, 512)))
    check(nu <= 4, f"threefry.normal card vs CPU {nu} ulp")
    res["threefry_normal_max_ulp_vs_cpu"] = nu
    xs = torch.from_numpy(np.random.default_rng(4).normal(
        0, 3, (256, 256)).astype(np.float32))
    m = xs > 0
    res["masked_variance_rel"] = rel_err(masked_variance(xs.to(dev),
                                                         m.to(dev), 0),
                                         masked_variance(xs, m, 0))
    res["mse_2d_rel"] = rel_err(mse_2d(xs[:, :2].to(dev), xs[:, 2:4].to(dev),
                                       m[:, 0].to(dev)),
                                mse_2d(xs[:, :2], xs[:, 2:4], m[:, 0]))
    check(res["masked_variance_rel"] <= 1e-5 and res["mse_2d_rel"] <= 1e-5,
          "masked statistics card vs CPU")
    return res


def phase16_slice3_times(card: str, s3: dict) -> dict:
    from compv_tpu_torch.calib.camera import (CalibrationConfig,
                                              calibrate_camera)
    from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                    find_chessboard_corners)
    from compv_tpu_torch.calib.utils import undistort_image
    from compv_tpu_torch.slam.pipeline import (PlanarTrackerConfig,
                                               track_planar_sequence)
    from compv_tpu_torch.slam.posegraph import (PoseGraphConfig,
                                                optimize_pose_graph)

    views, obj, img_pts, cres = (s3["views"], s3["obj"], s3["img_pts"],
                                 s3["cres"])
    frames, graph = s3["frames"], s3["graph"]
    k4 = {"k4_launches": "sht_accumulate"}
    rows = {}

    def corners_all():
        for v in views:
            find_chessboard_corners(v, CheckerboardConfig())

    def calibration_path():
        found = [find_chessboard_corners(v, CheckerboardConfig())
                 for v in views]
        pts = torch.stack([f.corners for f in found if bool(f.valid)])
        calibrate_camera(obj, pts, CalibrationConfig())

    ms = cuda_ms(corners_all, reps=TIMING_REPS["corners"]) / len(views)
    rows["find_chessboard_corners_per_view"] = {
        "ms": ms, **device_profile(corners_all, ms * len(views), 1, k4)}
    for row in ("busy_ms", "kernel_launches", "device_ops", "k4_launches",
                "profiled_wall_ms"):
        v = rows["find_chessboard_corners_per_view"][row]
        rows["find_chessboard_corners_per_view"][row] = (
            None if v is None else v / len(views))
    ms = cuda_ms(lambda: calibrate_camera(obj, img_pts, CalibrationConfig()),
                 reps=TIMING_REPS["calibration"])
    rows["calibrate_camera"] = {"ms": ms, **device_profile(
        lambda: calibrate_camera(obj, img_pts, CalibrationConfig()), ms, 1)}
    ms = cuda_ms(calibration_path, reps=TIMING_REPS["calibration"])
    rows["calibration_path_8_views"] = {
        "ms": ms, **device_profile(calibration_path, ms, 1, k4)}
    ms = cuda_ms(lambda: undistort_image(views[0], cres.k, cres.dist),
                 reps=TIMING_REPS["undistort"])
    rows["undistort_image_720x1280"] = {"ms": ms, **device_profile(
        lambda: undistort_image(views[0], cres.k, cres.dist), ms)}
    n = len(frames)
    ms = cuda_ms(lambda: track_planar_sequence(frames, PlanarTrackerConfig()),
                 reps=TIMING_REPS["track"])
    prof = device_profile(lambda: track_planar_sequence(
        frames, PlanarTrackerConfig()), ms, 1, {"k1_launches": "fast_kernel"})
    rows["track_planar_sequence_per_frame"] = {
        "ms": ms / n, "frames": n, "idle_share": prof["idle_share"],
        **{key: None if v is None else v / n for key, v in prof.items()
           if key != "idle_share"}}
    ms = cuda_ms(lambda: optimize_pose_graph(graph, PoseGraphConfig()),
                 reps=TIMING_REPS["posegraph"])
    rows["optimize_pose_graph_sphere2500"] = {"ms": ms, **device_profile(
        lambda: optimize_pose_graph(graph, PoseGraphConfig()), ms, 1)}
    emit({"phase": 16, "card": card, **rows,
          "timing": "median of CUDA-event timings after two warm-up calls; "
                    "busy, idle share and launches by torch.profiler, per "
                    "view or frame where the row says so"})
    return rows


def bench_inputs(scene: np.ndarray) -> dict:
    """bench.py:109-125's inputs of the slice-4 rows: the scene, its rolled
    RGB, the seeded I420 chroma u_p / v_p and the 1285x1285 binary big_bin
    (the generator's draws in bench.py's order)."""
    h, w = scene.shape
    rs = np.random.default_rng(1)
    rgb = np.stack([scene, np.roll(scene, 3, 0), np.roll(scene, 7, 1)], -1)
    u_p = rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8)
    v_p = rs.integers(0, 255, (h // 2, w // 2), dtype=np.uint8)
    for shape in ((200, 256), (258, 256), (2048, 256), (2048, 256)):
        rs.integers(0, 2, shape, dtype=np.uint8)   # the matcher's inputs
    big_bin = rs.integers(0, 2, (1285, 1285), dtype=np.uint8) * 255
    return {"gray": scene, "rgb": rgb, "u_p": u_p, "v_p": v_p,
            "big_bin": big_bin}


def slice4_image_rows(inputs: dict) -> dict:
    """{row: (fn, args, bar)} of phase 17 (a): bench.py's slice-4 rows by
    their names, then the other conversions, LUT, projections and morph
    operators, on bench.py's inputs. bar is "exact" or a relative
    tolerance."""
    from compv_tpu_torch.image import color, histogram, morph, threshold
    from compv_tpu_torch.image.integral import (box_mean_var, integral,
                                                integral_squared)

    gray, rgb = inputs["gray"], inputs["rgb"]
    u_p, v_p, big = inputs["u_p"], inputs["v_p"], inputs["big_bin"]
    h, w = gray.shape
    rgba = np.concatenate([rgb, gray[..., None]], -1)
    uv = np.stack([u_p, v_p], -1)
    packed = np.ascontiguousarray(np.stack(
        [gray[:, 0::2], u_p.repeat(2, 0), gray[:, 1::2], v_p.repeat(2, 0)],
        -1).reshape(h, w * 2))
    se3 = morph.strel("cross", 3)
    lut = (255 - np.arange(256)).astype(np.float32)

    def yuv420p_to_hsv(y, u, v):
        return color.yuv444_to_hsv(y, color._upsample2(u, h, w),
                                   color._upsample2(v, h, w))

    return {
        "rgb24_to_gray": (color.rgb_to_gray, (rgb,), "exact"),
        "i420_to_rgb24": (color.i420_to_rgb, (gray, u_p, v_p), "exact"),
        "rgb24_to_hsv": (color.rgb_to_hsv, (rgb,), "exact"),
        "yuv420p_to_hsv": (yuv420p_to_hsv, (gray, u_p, v_p), "exact"),
        # the planes materialized (the port's split gives views)
        "split_rgb": (lambda x: torch.stack(color.split_channels(x)), (rgb,),
                      "exact"),
        "hist_equalize": (histogram.equalize, (gray,), "exact"),
        "integral_sq": (lambda x: integral_squared(x, torch.float32),
                        (gray,), 1e-6),
        "integral_f32": (lambda x: integral(x, torch.float32), (gray,), 1e-6),
        "adaptive_thresh_5x5": (lambda x: threshold.threshold_adaptive(
            x, 5, 21), (gray,), "exact"),
        "wolf_binarization_41x41": (lambda x: threshold.threshold_wolf(
            x, 41), (gray,), "exact"),
        "morph_erode_3x3": (lambda x: morph.erode(x, se3), (big,), "exact"),
        "morph_close_3x3": (lambda x: morph.close_(x, se3), (big,), "exact"),
        "integral_u8": (integral, (gray,), "exact"),
        "box_mean_var_41": (lambda x: torch.stack(box_mean_var(x, 41)),
                            (gray,), "exact"),
        "bgr24_to_gray": (color.bgr_to_gray, (rgb,), "exact"),
        "rgba32_to_gray": (color.rgba_to_gray, (rgba,), "exact"),
        "rgb24_to_yuv444": (lambda x: torch.stack(color.rgb_to_yuv444(x)),
                            (rgb,), "exact"),
        "rgb24_to_i420_y": (lambda x: color.rgb_to_i420(x)[0], (rgb,),
                            "exact"),
        "nv12_to_rgb24": (color.nv12_to_rgb, (gray, uv), "exact"),
        "nv21_to_rgb24": (color.nv21_to_rgb, (gray, uv), "exact"),
        "i422_to_rgb24": (color.i422_to_rgb,
                          (gray, u_p.repeat(2, 0), v_p.repeat(2, 0)),
                          "exact"),
        "yuyv_to_rgb24": (color.yuyv_to_rgb, (packed,), "exact"),
        "uyvy_to_rgb24": (color.uyvy_to_rgb, (packed,), "exact"),
        "rgb24_to_hsl": (color.rgb_to_hsl, (rgb,), "exact"),
        "rgb24_to_rgb565": (lambda x: color.rgb_to_rgb565(x).to(torch.int32),
                            (rgb,), "exact"),
        "rgb565_to_rgb24": (lambda x: color.rgb565_to_rgb(
            color.rgb_to_rgb565(x)), (rgb,), "exact"),
        "merge_rgb": (lambda x: color.merge_channels(
            *color.split_channels(x)[::-1]), (rgb,), "exact"),
        "apply_lut256": (lambda x: histogram.apply_lut256(
            x, torch.from_numpy(lut).to(x.device)), (gray,), "exact"),
        "projection_x": (histogram.projection_x, (gray,), "exact"),
        "projection_y": (histogram.projection_y, (gray,), "exact"),
        "morph_dilate_3x3": (lambda x: morph.dilate(x, se3), (big,), "exact"),
        "morph_open_rect5": (lambda x: morph.open_(x, morph.strel("rect", 5)),
                             (gray,), "exact"),
        "morph_gradient_3x3": (morph.morph_gradient, (gray,), "exact"),
        "top_hat_3x3": (morph.top_hat, (gray,), "exact"),
        "black_hat_3x3": (morph.black_hat, (gray,), "exact"),
    }


def slice4_goldens(dev) -> list:
    """md5_rgb_to_hsv, md5_integral, md5_erode_3x3 and md5_dilate_3x3 of
    scripts/make_goldens.py:56-65, computed on the card."""
    from compv_tpu_torch.core.golden import exact_hash
    from compv_tpu_torch.image.color import rgb_to_hsv
    from compv_tpu_torch.image.integral import integral
    from compv_tpu_torch.image.morph import dilate, erode
    from compv_tpu_torch.image.threshold import threshold_otsu

    fixtures = load_fixtures()
    with open(os.path.join(ROOT, "goldens", "goldens.json")) as f:
        goldens = json.load(f)
    gray = torch.from_numpy(fixtures.make_test_image()).to(dev)
    rgb = torch.from_numpy(fixtures.make_test_rgb()).to(dev)
    binary = threshold_otsu(gray)[0]
    got = {"md5_rgb_to_hsv": exact_hash(rgb_to_hsv(rgb)),
           "md5_integral": exact_hash(integral(gray).to(torch.int64)),
           "md5_erode_3x3": exact_hash(erode(binary)),
           "md5_dilate_3x3": exact_hash(dilate(binary))}
    for key, value in got.items():
        check(value == goldens[key], f"{key} on the card: {value}")
    return sorted(got)


def to_dev(args, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 if isinstance(a, np.ndarray) else a for a in args)


def slice4_math(dev, scene: np.ndarray) -> dict:
    """Phase 17 (b): moments, the polynomial atan2 of the scene's Sobel
    gradients, saturating ops on 720p planes, batched decompositions with
    singular members, card against CPU."""
    from compv_tpu_torch.features.edges import sobel_gradients
    from compv_tpu_torch.math import matrix, ops

    res = {}
    g = torch.from_numpy(scene)
    mom, mom_cpu = ops.image_moments(g.to(dev), 3), ops.image_moments(g, 3)
    res["image_moments_rel"] = max(rel_err(mom[k], mom_cpu[k]) for k in mom)
    res["hu_moments_rel"] = rel_err(ops.hu_moments(g.to(dev)),
                                    ops.hu_moments(g))
    check(res["image_moments_rel"] <= 1e-5 and res["hu_moments_rel"] <= 1e-4,
          f"moments card vs CPU {res['image_moments_rel']}, "
          f"{res['hu_moments_rel']}")
    gx, gy = sobel_gradients(g.to(dev))
    fast = ops.fast_atan2_deg(gy, gx)
    exact = ops.atan2_deg_exact(gy, gx)
    err = (fast - exact).abs()
    err = torch.minimum(err, 360.0 - err)
    res["fast_atan2_deg_max_err_deg"] = float(err.max())
    check(res["fast_atan2_deg_max_err_deg"] <= 0.011,
          f"fast_atan2_deg off by {res['fast_atan2_deg_max_err_deg']} deg")
    check(torch.equal(fast.cpu(), ops.fast_atan2_deg(gy.cpu(), gx.cpu())),
          "fast_atan2_deg card != CPU")
    ex_cpu = ops.atan2_deg_exact(gy.cpu(), gx.cpu())
    res["atan2_deg_exact_max_diff_vs_cpu"] = float(
        (exact.cpu() - ex_cpu).abs().max())
    rs = np.random.default_rng(17)
    planes = {"u8": rs.integers(0, 256, (2, 720, 1282), dtype=np.uint8),
              "i16": rs.integers(-32768, 32768, (2, 720, 1282),
                                 dtype=np.int64).astype(np.int16),
              "u16": rs.integers(0, 65536, (2, 720, 1282),
                                 dtype=np.int64).astype(np.uint16)}
    for name, p in planes.items():
        a, b = torch.from_numpy(p[0]), torch.from_numpy(p[1])
        for op in ("add", "sub", "mul_elementwise"):
            got = getattr(ops, op)(a.to(dev), b.to(dev))
            check(got.dtype == a.dtype and torch.equal(
                got.cpu(), getattr(ops, op)(a, b)),
                f"{op} on {name} planes: card != CPU")
    res["saturating_ops_720p"] = "exact (u8, i16, u16; add, sub, mul)"
    # 4,096 symmetric 3x3; 4,096 general 3x3, well conditioned but for a
    # quarter of small integers that are singular (rank 1 or 2: their det is
    # 0 exactly in the cofactor expansion, on both devices)
    sym = rs.normal(0, 1, (4096, 3, 3)).astype(np.float32)
    sym = sym + sym.transpose(0, 2, 1)
    mats = (rs.normal(0, 1, (4096, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    ints = rs.integers(-4, 5, (1024, 3, 3)).astype(np.float32)
    ints[:512] = ints[:512, :, :1] * ints[:512, :1, :]       # rank <= 1
    ints[512:, 2] = ints[512:, 0] + ints[512:, 1]            # rank <= 2
    mats[:1024] = ints
    s_dev = torch.from_numpy(sym).to(dev)
    m_dev = torch.from_numpy(mats).to(dev)
    vals, vecs = matrix.eigen_symm(s_dev)
    vals_c = matrix.eigen_symm(torch.from_numpy(sym))[0]
    res["eigen_symm_values_rel"] = rel_err(vals, vals_c)
    # the vectors by what they reconstruct (their signs are the solver's)
    res["eigen_symm_reconstruction_rel"] = rel_err(
        (vecs * vals[:, None, :]) @ vecs.mT, torch.from_numpy(sym))
    u, sv, vt = matrix.svd(m_dev)
    res["svd_reconstruction_rel"] = rel_err((u * sv[:, None, :]) @ vt,
                                            torch.from_numpy(mats))
    res["svd_values_rel"] = rel_err(sv, matrix.svd(torch.from_numpy(mats))[1])
    res["pseudo_inverse_rel"] = rel_err(
        matrix.pseudo_inverse(m_dev), matrix.pseudo_inverse(
            torch.from_numpy(mats)))
    inv = matrix.inverse_3x3(m_dev)
    inv_c = matrix.inverse_3x3(torch.from_numpy(mats))
    singular = matrix.determinant(torch.from_numpy(mats)).abs() <= 1e-12
    check(torch.equal(matrix.determinant(m_dev).cpu().abs() <= 1e-12,
                      singular) and int(singular.sum()) == 1024,
          "inverse_3x3: the singular set differs")
    res["inverse_3x3_singular"] = int(singular.sum())
    res["inverse_3x3_rel"] = rel_err(inv, inv_c)
    check(max(res["eigen_symm_values_rel"], res["svd_values_rel"],
              res["eigen_symm_reconstruction_rel"],
              res["svd_reconstruction_rel"]) <= 1e-5
          and bool(torch.isfinite(inv).all())
          and max(res["pseudo_inverse_rel"], res["inverse_3x3_rel"]) <= 1e-4,
          f"decompositions card vs CPU {res}")
    return res


def hog_card_vs_cpu(dev, scene: np.ndarray) -> dict:
    """Phase 17 (c): HOG at 720x1282, every interp mode with L2-Hys and
    every norm with bilinear, card against CPU by the tests' tolerances;
    for the step modes, the pixels whose vote moves (one-pixel cells)."""
    from compv_tpu_torch.features.hog import HogConfig, hog_descriptor

    g = torch.from_numpy(scene)
    gd = g.to(dev)
    res = {}
    configs = [("l2hys_" + m, HogConfig(interp=m))
               for m in ("nearest", "bilinear", "bilinear_lut")]
    configs += [("bilinear_" + n, HogConfig(norm=n))
                for n in ("none", "l1", "l1sqrt", "l2")]
    for name, cfg in configs:
        a = hog_descriptor(gd, cfg).cpu()
        b = hog_descriptor(g, cfg)
        moved = 0
        if cfg.interp != "bilinear":
            one = HogConfig(cell_size=1, block_size=1, norm="none",
                            interp=cfg.interp)
            pa, pb = hog_descriptor(gd, one).cpu(), hog_descriptor(g, one)
            mag = pb.abs().sum(-1).clamp_min(1.0)
            moved = int(((pa - pb).abs() > 1e-4 * mag[..., None]).any(-1)
                        .sum())
        if cfg.norm == "l1sqrt":
            a, b = a * a, b * b
        diff = float((a - b).abs().max())
        tol = 2e-6 * max(1.0, float(b.abs().max()))
        check(moved <= 16 and (moved > 0 or diff <= tol),
              f"HOG {name} card vs CPU: {diff} > {tol}, {moved} pixels "
              "moved")
        res[name] = {"max_diff": diff, "tolerance": tol,
                     "pixels_moved": moved}
    first = hog_descriptor(gd, HogConfig())
    check(torch.equal(first, hog_descriptor(gd, HogConfig())),
          "HOG: a second card run differs")
    res["second_run"] = "identical"
    return res


def hog_classifier(dev, scene: np.ndarray) -> dict:
    """Phase 17 (d): the 720p descriptor -> 11,475 windows of 3,780 values
    -> RBF and linear SVMs trained on 2,048, PCA to 64 and a 5-NN vote, the
    ANN index's recall, Platt scaling; on the card, against the reference's
    counts (HOG_SVM_REF) and the port on the CPU on the same windows."""
    from compv_tpu_torch.features.hog import HogConfig, hog_descriptor
    from compv_tpu_torch.math.pca import pca_compute, pca_project
    from compv_tpu_torch.ml.knn import (AnnConfig, ann_build, ann_search,
                                        knn_build, knn_search)
    from compv_tpu_torch.ml.svm import (SvmConfig, platt_fit, svm_decision,
                                        svm_train)

    desc = hog_descriptor(torch.from_numpy(scene).to(dev), HogConfig())
    windows = hog_windows(desc)
    labels_np = hog_window_labels(tuple(desc.shape))
    train_np = hog_train_index(windows.shape[0])
    labels = torch.from_numpy(labels_np).to(dev)
    train = torch.from_numpy(train_np).to(dev)
    x, y = windows[train], labels[train]
    w_cpu, x_cpu, y_cpu = windows.cpu(), x.cpu(), y.cpu()
    res = {"windows": int(windows.shape[0]), "dim": int(windows.shape[1]),
           "positive_share": float((labels_np > 0).mean())}

    def correct(dec):
        return int((torch.where(dec >= 0, 1.0, -1.0) == labels).sum())

    models = {}
    for name, cfg in (("rbf", SvmConfig()),
                      ("linear", SvmConfig(kernel="linear"))):
        m = svm_train(x, y, cfg)
        dec = svm_decision(m, windows)
        m_cpu = svm_train(x_cpu, y_cpu, cfg)
        dec_cpu = svm_decision(m_cpu, w_cpu)
        sure = dec_cpu.abs() >= 1e-3
        same = torch.equal((dec.cpu() >= 0)[sure], (dec_cpu >= 0)[sure])
        ref = HOG_SVM_REF[f"{name}_correct"]
        res[name] = {"correct": correct(dec), "reference": ref,
                     "correct_cpu": int((torch.where(dec_cpu >= 0, 1.0, -1.0)
                                         == labels.cpu()).sum()),
                     "min_abs_decision": float(dec.abs().min()),
                     "alpha_rel_vs_cpu": rel_err(m.alpha_y, m_cpu.alpha_y),
                     "decision_rel_vs_cpu": rel_err(dec, dec_cpu),
                     "labels_equal_cpu_where_sure": same,
                     "windows_below_1e-3": int((~sure).sum())}
        check(abs(res[name]["correct"] - ref) <= 2 and same,
              f"{name} SVM: {res[name]}")
        models[name] = (m, dec)
    pca = pca_compute(windows, 64)
    proj, proj_x = pca_project(pca, windows), pca_project(pca, x)
    idx, _ = knn_search(knn_build(proj_x), proj, 5)
    vote = knn_vote(y[idx.long()])
    pca_cpu = pca_compute(w_cpu, 64)
    idx_cpu, _ = knn_search(knn_build(pca_project(pca_cpu, x_cpu)),
                            pca_project(pca_cpu, w_cpu), 5)
    vote_cpu = knn_vote(y_cpu[idx_cpu.long()])
    vals = pca.values.cpu()
    res["pca_knn5"] = {
        "correct": int((vote == labels).sum()),
        "reference": HOG_SVM_REF["knn5_correct"],
        "correct_cpu": int((vote_cpu == labels.cpu()).sum()),
        "votes_equal_cpu": int((vote.cpu() == vote_cpu).sum()),
        "eig_first": float(vals[0]), "eig_64th": float(vals[-1]),
        "eig_rel_vs_cpu": rel_err(pca.values, pca_cpu.values),
        "reference_eig": [HOG_SVM_REF["pca_eig_first"],
                          HOG_SVM_REF["pca_eig_64th"]]}
    check(abs(res["pca_knn5"]["correct"] - HOG_SVM_REF["knn5_correct"]) <= 2
          and res["pca_knn5"]["eig_rel_vs_cpu"] <= 1e-4,
          f"PCA + 5-NN: {res['pca_knn5']}")
    ann = ann_build(proj_x, AnnConfig())
    aidx, _ = ann_search(ann, proj, 5, AnnConfig())
    recall = float((aidx[:, :, None] == idx[:, None, :]).any(-1).float()
                   .mean())
    aidx_cpu, _ = ann_search(ann_build(proj_x.cpu(), AnnConfig()),
                             proj.cpu(), 5, AnnConfig())
    res["ann"] = {"recall_at_5_vs_exact": recall,
                  "index_equal_cpu": float((aidx.cpu() == aidx_cpu).float()
                                           .mean()),
                  "correct": int((knn_vote(y[aidx.long()]) == labels).sum())}
    check(recall >= 0.5, f"ANN recall {recall}")
    # Platt scaling of the RBF decisions, against scipy's minimum
    dec = models["rbf"][1]
    a, b = platt_fit(dec, labels)
    res["platt"] = platt_vs_scipy(dec.cpu().numpy(), labels_np,
                                  float(a), float(b))
    check(res["platt"]["rel_err"] <= 1e-4, f"platt_fit {res['platt']}")
    return {"res": res, "x": x, "y": y, "windows": windows, "proj": proj,
            "proj_x": proj_x, "rbf": models["rbf"][0]}


def platt_vs_scipy(dec: np.ndarray, y: np.ndarray, a: float, b: float
                   ) -> dict:
    """(A, B) against the minimum scipy's BFGS finds in float64 for the
    regularized sigmoid NLL of libsvm's sigmoid_train."""
    import scipy.optimize

    dec = dec.astype(np.float64)
    n_pos, n_neg = (y > 0).sum(), (y <= 0).sum()
    t = np.where(y > 0, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))

    def nll(ab):
        z = ab[0] * dec + ab[1]
        return float(np.sum(np.logaddexp(0.0, z) - (1.0 - t) * z))

    def grad(ab):
        d = t - 1.0 / (1.0 + np.exp(ab[0] * dec + ab[1]))
        return np.array([np.sum(d * dec), np.sum(d)])

    opt = scipy.optimize.minimize(nll, np.zeros(2), jac=grad, method="BFGS",
                                  options={"gtol": 1e-10, "maxiter": 1000})
    sa, sb = opt.x
    return {"a": a, "b": b, "scipy_a": float(sa), "scipy_b": float(sb),
            "rel_err": max(abs(a - sa) / max(1.0, abs(sa)),
                           abs(b - sb) / max(1.0, abs(sb))),
            "nll": nll(np.array([a, b])), "scipy_nll": float(opt.fun)}


def launch_counts() -> dict:
    """The hand kernels' launch counters."""
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls
    from compv_tpu_torch.ops.kernels import level_areas as la
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    return {"K1": fk.launches, "K2a": ck.ccl_label.launches,
            "K2b": ck.ccl_label_seeded.launches,
            "K3": cpk.compact_rows.launches,
            "K4": hk.sht_accumulate.launches,
            "K5": ls.strip_label_counts.launches,
            "K6": ok.launches, "K7": la.launches}


def reset_launch_counts() -> None:
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import compact_kernel as cpk
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.ops.kernels import hough_kernel as hk
    from compv_tpu_torch.ops.kernels import label_stats as ls
    from compv_tpu_torch.ops.kernels import level_areas as la
    from compv_tpu_torch.ops.kernels import orient_kernel as ok

    fk.launches = ok.launches = la.launches = 0
    for fn in (ck.ccl_label, ck.ccl_label_seeded, cpk.compact_rows,
               hk.sht_accumulate, ls.strip_label_counts):
        fn.launches = 0


def phase17_slice4(dev, scene: np.ndarray) -> dict:
    torch.cuda.synchronize()
    reset_launch_counts()
    inputs = bench_inputs(scene)
    rows = slice4_image_rows(inputs)
    out = {"image_rows": {}}
    for name, (fn, args, bar) in rows.items():
        got = fn(*to_dev(args, dev))
        want = fn(*to_dev(args, "cpu"))
        if bar == "exact":
            check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
                  f"{name}: card != CPU")
            out["image_rows"][name] = "exact"
        else:
            err = rel_err(got, want)
            check(err <= bar, f"{name}: card vs CPU {err} > {bar}")
            out["image_rows"][name] = {"rel_err": err, "bar": bar}
    out["goldens_on_card"] = slice4_goldens(dev)
    out["math"] = slice4_math(dev, scene)
    out["hog_720p"] = hog_card_vs_cpu(dev, scene)
    cls = hog_classifier(dev, scene)
    out["classifier"] = cls["res"]
    torch.cuda.synchronize()
    out["hand_kernel_launches"] = launch_counts()
    check(not any(out["hand_kernel_launches"].values()),
          f"slice 4 launched a hand kernel: {out['hand_kernel_launches']}")
    emit({"phase": 17, **out,
          "bars": "image rows bit-equal to the CPU (integral_sq and the f32 "
                  "integral within 1e-6 relative), the four md5 goldens on "
                  "the card, HOG within the tests' tolerances of the CPU "
                  "and two card runs identical, classifier counts within "
                  "2 of the reference's and labels as the CPU's wherever "
                  "|decision| >= 1e-3, platt_fit within 1e-4 of scipy's "
                  "minimum; no hand kernel on this path"})
    return {"inputs": inputs, "rows": rows, **cls}


def phase18_slice4_times(dev, card: str, s4: dict) -> dict:
    from compv_tpu_torch.features.hog import HogConfig, hog_descriptor
    from compv_tpu_torch.image.integral import integral
    from compv_tpu_torch.math.pca import pca_compute
    from compv_tpu_torch.ml.knn import knn_build, knn_search
    from compv_tpu_torch.ml.svm import SvmConfig, svm_decision, svm_train

    times = {}

    # 20 profiled calls a row: a window of the full script can come back
    # ~22 device events short (seen after phase 16's windows), which is
    # most of a 10-event row's single call
    def row(name, fn, reps, calls=20):
        ms = cuda_ms(fn, reps=reps)
        times[name] = {"ms": ms, **device_profile(fn, ms, calls)}

    bench_rows = ("rgb24_to_gray", "i420_to_rgb24", "rgb24_to_hsv",
                  "yuv420p_to_hsv", "split_rgb", "hist_equalize",
                  "integral_sq", "adaptive_thresh_5x5",
                  "wolf_binarization_41x41", "morph_erode_3x3",
                  "morph_close_3x3")
    for name in bench_rows:
        fn, args, _ = s4["rows"][name]
        args = to_dev(args, dev)
        if name == "integral_sq":    # bench.py's row: both tables
            row(name, lambda a=args: (integral(a[0], torch.float32),
                                      fn(*a)), 20)
        else:
            row(name, lambda f=fn, a=args: f(*a), 20)
    gray = torch.from_numpy(s4["inputs"]["gray"]).to(dev)
    row("hog_8x8_l2hys", lambda: hog_descriptor(gray, HogConfig()), 10)
    x, y, windows = s4["x"], s4["y"], s4["windows"]
    row("svm_train_rbf_2048", lambda: svm_train(x, y, SvmConfig()), 3, 3)
    row("svm_decision_rbf_11475", lambda: svm_decision(s4["rbf"], windows), 5)
    row("pca_compute_11475x3780_64", lambda: pca_compute(windows, 64), 2, 2)
    index = knn_build(s4["proj_x"])
    row("knn_search_11475_k5", lambda: knn_search(index, s4["proj"], 5), 10)
    emit({"phase": 18, "card": card, **times,
          "timing": "median of CUDA-event timings after two warm-up calls; "
                    "busy, idle share and launches by torch.profiler, mean "
                    "of 20 profiled calls (3 for svm_train, 2 for "
                    "pca_compute)"})
    return times


# ---------------------------------------------------------------------------
# slice 5: the host layer (config file -> registry, native loader, upload,
# draw, writer / stream, profiling) driven as the reference's two demo
# paths: examples/object_recognition.py's recording chain and
# examples/live_demo.py's live loop, each through K1

# phase 4's configuration, written as a user would write its file
SLICE5_YAML = """\
# the 720p frontend pair
orb:
  max_features: 2000
  levels: 8
frontend:
  orb:
    max_features: 2000
    levels: 8
  homography:
    num_hypotheses: 512
    threshold: 30.0
  ratio: 0.67
"""
# the reference (compv_tpu, JAX 0.9.0 on a CPU) on the recording path's 31
# pairs, from scripts/recording_reference.py: (t, matches, inliers, its H's
# largest distance from the true shift (3t, 2t) on phase 4's grid in px, H
# row-major). On this scene and these shifts phase 4's own bars (inliers at
# least half the matches, H within 1 px) do not hold for the reference
# itself: inliers are 46-65 % of the matches, and H misses by up to 3.06 px
# (t 21). The card is held to the reference instead.
RECORDING_REF = [
    (1, 488, 255, 0.291,
     [1.000802, -0.0002412524, 2.764465, 0.0001417162, 1.000184, 1.98273,
      5.48855e-07, -3.08937e-07, 1.0]),
    (2, 548, 288, 0.244,
     [1.000645, -0.0001457551, 5.77026, 0.0003042521, 0.9999462, 3.833448,
      3.65451e-07, -2.320516e-07, 1.0]),
    (3, 583, 310, 0.287,
     [1.000677, 0.0003388497, 8.62079, 3.755343e-05, 1.00067, 5.94644,
      1.098802e-07, 7.661988e-07, 1.0]),
    (4, 512, 234, 0.204,
     [1.000596, 0.00046436, 11.69575, 0.0001942253, 1.00063, 7.83306,
      3.972381e-07, 1.639362e-07, 1.0]),
    (5, 539, 295, 0.245,
     [0.9994373, -0.0004927554, 15.25326, 4.179569e-05, 0.9996628, 9.964391,
      -2.066488e-07, -7.33881e-07, 1.0]),
    (6, 574, 364, 0.158,
     [0.9997422, -0.0005713826, 18.23329, -1.698187e-05, 0.9996467,
      12.06569, 2.615863e-08, -6.8551e-07, 1.0]),
    (7, 633, 384, 2.983,
     [0.9985426, -0.007192369, 22.2376, -9.48764e-05, 0.9976003, 14.2341,
      -5.717656e-07, -5.165903e-06, 1.0]),
    (8, 531, 259, 0.208,
     [1.000529, -0.0001782032, 23.83906, -4.166033e-05, 1.00017, 15.97065,
      2.49323e-07, -1.757744e-07, 1.0]),
    (9, 497, 233, 0.382,
     [1.000678, -0.0009682208, 27.04499, 0.0003727741, 0.9995648, 17.84927,
      8.800782e-07, -1.481301e-06, 1.0]),
    (10, 487, 252, 0.199,
     [1.000923, -0.0001215734, 29.78987, 0.0002542881, 1.00051, 19.80885,
      7.072676e-07, -4.473808e-08, 1.0]),
    (11, 523, 274, 0.229,
     [1.000764, -0.0004132872, 33.00133, 0.000363824, 1.000295, 21.70771,
      7.778005e-07, -5.604974e-07, 1.0]),
    (12, 550, 302, 0.168,
     [1.000536, 0.0003330251, 35.85512, 1.203346e-05, 1.000748, 23.88875,
      3.463614e-07, 4.095095e-07, 1.0]),
    (13, 488, 269, 0.401,
     [1.00133, -0.0002877479, 38.6245, 0.0004428862, 1.000276, 25.80015,
      9.489663e-07, -3.812669e-07, 1.0]),
    (14, 599, 388, 0.172,
     [1.000484, -0.0001823383, 41.97483, 0.0002003179, 1.000362, 27.8035,
      4.830386e-07, -1.207605e-07, 1.0]),
    (15, 495, 260, 0.484,
     [1.002155, 0.0005344733, 44.27895, 0.0006536921, 1.001587, 29.52937,
      1.304083e-06, 8.802542e-07, 1.0]),
    (16, 554, 314, 0.202,
     [1.000391, 0.0004859164, 47.86159, 0.0002003706, 1.000681, 31.8092,
      2.250718e-07, 6.570444e-07, 1.0]),
    (17, 499, 284, 0.295,
     [1.000909, -9.115478e-05, 50.77587, 0.000189961, 1.000234, 33.87476,
      6.366132e-07, 1.170103e-07, 1.0]),
    (18, 571, 281, 0.2,
     [1.000663, 0.0005184663, 53.69688, 6.698663e-05, 1.00074, 35.97051,
      2.407806e-07, 7.535984e-07, 1.0]),
    (19, 556, 302, 0.262,
     [1.000958, -4.752446e-05, 56.67073, 0.0003939228, 1.000627, 37.68524,
      6.685363e-07, -1.186799e-07, 1.0]),
    (20, 500, 245, 0.533,
     [1.00236, -7.289238e-05, 59.33812, 0.00073929, 1.001318, 39.53023,
      1.475404e-06, 3.881846e-07, 1.0]),
    (21, 588, 354, 3.058,
     [1.002848, 0.008694399, 60.8643, 0.0008427337, 1.010831, 39.75881,
      -2.962046e-08, 1.263852e-05, 1.0]),
    (22, 507, 281, 0.307,
     [1.000591, 0.0006876145, 65.65916, -0.0001479027, 1.000373, 44.1371,
      1.286652e-07, 9.718622e-07, 1.0]),
    (23, 476, 242, 0.369,
     [1.001008, 0.0004481626, 68.69567, 0.0002698203, 1.001186, 45.67722,
      5.848191e-07, 8.660633e-07, 1.0]),
    (24, 518, 291, 0.838,
     [0.9984422, -0.002700832, 72.68818, -0.0002027739, 0.9984879, 48.15941,
      -9.238916e-07, -2.715139e-06, 1.0]),
    (25, 447, 207, 0.42,
     [0.9997945, -0.001479509, 75.36545, 0.0004552026, 0.9990188, 49.87602,
      2.774403e-07, -1.4518e-06, 1.0]),
    (26, 519, 259, 0.328,
     [1.001547, -0.0002030171, 77.78766, 0.000528986, 1.000932, 51.70199,
      1.195829e-06, 5.160144e-08, 1.0]),
    (27, 539, 288, 1.462,
     [0.9988108, 0.003678117, 80.61624, 0.0007055129, 1.004773, 52.43933,
      -2.027224e-06, 6.361777e-06, 1.0]),
    (28, 615, 342, 0.287,
     [1.000803, 4.759541e-05, 83.8657, 0.0002245157, 1.000611, 55.81612,
      6.578242e-07, 1.896174e-07, 1.0]),
    (29, 565, 322, 0.287,
     [1.000973, -0.0001908949, 86.73035, 0.0002082601, 1.000485, 57.87779,
      7.30174e-07, -1.522868e-07, 1.0]),
    (30, 502, 257, 0.611,
     [1.001903, -0.000790099, 89.66096, 0.0003885521, 1.000792, 59.68336,
      1.30303e-06, -4.413852e-07, 1.0]),
    (31, 531, 254, 0.166,
     [1.000044, -0.0001233435, 92.95439, -0.000101017, 1.000024, 62.01928,
      9.180947e-08, -5.343447e-08, 1.0])]


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def orb_levels_used(h: int, w: int, cfg) -> int:
    """Pyramid levels on which ORB runs K1 (the others are too small for
    its patch)."""
    from compv_tpu_torch.features.orb import PATCH_DIAMETER
    from compv_tpu_torch.image.pyramid import pyramid_sizes

    return sum(1 for lh, lw in pyramid_sizes(h, w, cfg.levels,
                                             cfg.scale_factor)
               if lh >= PATCH_DIAMETER + 2 and lw >= PATCH_DIAMETER + 2)


def same_tree(a, b) -> bool:
    """Equal results: tensors (and NamedTuples of them) equal exactly."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return a == b


def to_cpu(tree):
    """A NamedTuple of tensors, copied to the host field by field."""
    return type(tree)(*[t.cpu() for t in tree])


def config_and_registry(dev, scene: np.ndarray, workdir: str) -> dict:
    """The YAML file through load_config to phase 4's configuration, then
    every algorithm the registry lists and creates, once on the card, each
    against its direct call; a MserConfig saved and loaded again runs
    mser_detect (the reference's loaded one would not hash)."""
    from compv_tpu_torch import (create_detector, create_edge_detector,
                                 create_matcher, list_algorithms)
    from compv_tpu_torch.calib.homography import HomographyConfig
    from compv_tpu_torch.config import load_config, save_config
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.features.edges import edge_detect
    from compv_tpu_torch.features.fast import FastConfig, fast_detect
    from compv_tpu_torch.features.mser import MserConfig, mser_detect
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu_torch.matchers.bruteforce import (MatcherConfig,
                                                     match_bruteforce)
    from compv_tpu_torch.slam.frontend import FrontendConfig

    path = os.path.join(workdir, "slice5.yaml")
    with open(path, "w") as f:
        f.write(SLICE5_YAML)
    cfg = load_config(path, "frontend")
    phase4_cfg = FrontendConfig(orb=OrbConfig(max_features=2000, levels=8),
                                homography=HomographyConfig())
    check(cfg == phase4_cfg, f"YAML -> {cfg} != phase 4's {phase4_cfg}")
    check(load_config(path, "orb") == phase4_cfg.orb, "YAML orb block")
    mser_path = os.path.join(workdir, "mser.json")
    save_config(mser_path, mser=MserConfig())
    mser_cfg = load_config(mser_path, "mser")
    check(mser_cfg == MserConfig() and isinstance(mser_cfg.run_tiers, tuple),
          f"MserConfig round trip: {mser_cfg}")

    img = torch.from_numpy(scene).to(dev)
    rolled = torch.roll(img, (4, 7), (0, 1))
    algos = list_algorithms()
    direct = {
        "fast": lambda: fast_detect(img, FastConfig()),
        "orb": lambda: orb_detect_describe(img, OrbConfig()),
        "mser": lambda: mser_detect(img, mser_cfg),
        "canny": lambda: canny(img, CannyConfig()),
        **{op: lambda op=op: edge_detect(img, op)
           for op in ("sobel", "scharr", "prewitt")}}
    created = {}
    for name in algos["detectors"]:
        created[name] = create_detector(name)
    for name in algos["edges"]:
        created[name] = create_edge_detector(name)
    swept = {}
    for name, (fn, fcfg) in created.items():
        torch.cuda.synchronize()
        reset_launch_counts()
        got = fn(img, fcfg)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        check(same_tree(got, direct[name]()),
              f"registry {name} != its direct call")
        swept[name] = launches
    orb = created["orb"][0]
    d1 = orb(img, created["orb"][1])
    d2 = orb(rolled, created["orb"][1])
    for name in algos["matchers"]:
        fn, mcfg = create_matcher(name)
        args = (d1.descriptors, d2.descriptors)
        valid = (d1.keypoints.valid, d2.keypoints.valid)
        got = fn(*args, mcfg, *valid)
        check(same_tree(got, match_bruteforce(*args, MatcherConfig(),
                                              *valid)),
              f"registry {name} != its direct call")
        check(int(got.valid[0].sum()) > 100, f"{name}: too few matches")
        swept[name] = {}
    check(swept["fast"].get("K1") == 1, f"fast: {swept['fast']}")
    check(swept["orb"].get("K1") == orb_levels_used(*scene.shape, OrbConfig()),
          f"orb: {swept['orb']}")
    # MSER labels every level of its ladder with the seeded labeler
    check(swept["mser"].get("K2b", 0) >= 1, f"mser: {swept['mser']}")
    return {"cfg": cfg, "launches": swept,
            "yaml": "load_config == phase 4's FrontendConfig",
            "mser_round_trip": "equal, ran mser_detect"}


def recording_path(dev, scene: np.ndarray, cfg, workdir: str,
                   frames: int = RECORDING_FRAMES) -> dict:
    """examples/object_recognition.py's chain on a raw video: ``frames``
    I420 frames of ``scene``, frame t rolled by (2t, 3t), chroma from
    default_rng(1), written with VideoWriterRaw; read back through
    open_video (the native PrefetchLoader staging in the AlignedPool, its
    buffers recycled), each Y plane uploaded; every frame after the first
    matched against the first with match_pair, drawn with draw_matches +
    draw_text and written with VideoWriterRaw. Timer sections wait for the
    card around each stage."""
    from compv_tpu_torch import create_detector
    from compv_tpu_torch.io import VideoWriterRaw, open_video
    from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
    from compv_tpu_torch.native_rt import md5_mat
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.profiling import Timer
    from compv_tpu_torch.slam.frontend import match_pair
    from compv_tpu_torch.viz import draw_matches, draw_text

    h, w = scene.shape
    src = os.path.join(workdir, f"scene_{w}x{h}.yuv")
    uv = np.random.default_rng(1).integers(0, 256, (2, h // 2, w // 2),
                                           dtype=np.uint8)
    writer = VideoWriterRaw(src)
    written_md5 = []
    for t in range(frames):
        y = np.roll(scene, (2 * t, 3 * t), (0, 1))
        written_md5.append(hashlib.md5(y.tobytes()).hexdigest())
        writer.write(np.concatenate([y.ravel(), uv.ravel()]))
    writer.close()

    orb, _ = create_detector("orb")
    timer = Timer()

    def pair_step(template, r1, img, t, timer):
        """match_pair (and K1's launches in it), the matches to draw, the
        canvas."""
        done = []
        k1 = fk.launches
        with timer.section("match_pair", block_on=done):
            res = match_pair(template, img, cfg)
            done.append(res)
        k1 = fk.launches - k1
        with timer.section("orb_knn_for_draw", block_on=done):
            r2 = orb(img, cfg.orb)
            m = knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                          r2.keypoints.valid, k=2)
            ok = ratio_test(m, cfg.ratio)
            done.append((r2, m, ok))
        with timer.section("draw"):
            canvas = draw_matches(template, r1.keypoints, img, r2.keypoints,
                                  m, ok)
            plain = canvas.copy()
            draw_text(canvas, 4, 4, f"FRAME {t}  INLIERS "
                      f"{int(res.num_inliers)}", color=(0, 255, 0),
                      background=(0, 0, 0))
        return res, (r2, m, ok), plain, canvas, k1

    out = os.path.join(workdir, "recording.rgb")
    writer = VideoWriterRaw(out)
    reader = open_video(src, width=w, height=h, gray=False,
                        reuse_buffers=True)
    frames_it = iter(reader)
    read_md5, per_pair, pairs, kept = [], [], [], []
    template = r1 = template_np = None
    torch.cuda.synchronize()
    reset_launch_counts()
    t_start = time.perf_counter()
    for t in range(frames + 1):
        with timer.section("read"):
            y = next(frames_it, None)
        if y is None:
            break
        read_md5.append(md5_mat(y))
        up = []
        with timer.section("upload", block_on=up):
            # a copy, made before the generator resumes and recycles y
            img = torch.from_numpy(y).to(dev, copy=True)
            up.append(img)
        if template is None:
            template, template_np = img, y.copy()
            r1 = orb(template, cfg.orb)
            continue
        res, (r2, m, ok), plain, canvas, k1 = pair_step(template, r1, img, t,
                                                        timer)
        per_pair.append(k1)
        with timer.section("write"):
            writer.write(canvas)
        pairs.append((t, res, r2, m, ok, plain))
        if len(kept) < 4:
            kept.append(img)
    writer.close()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t_start) * 1e3
    launches = launch_counts()

    check(read_md5 == written_md5, "frames read != frames written, in order")
    check(os.path.getsize(out) == (frames - 1) * h * 2 * w * 3,
          f"recording holds {os.path.getsize(out)} bytes")
    levels = orb_levels_used(h, w, cfg.orb)
    check(per_pair == [2 * levels] * (frames - 1),
          f"K1 launches a match_pair: {per_pair}")
    gy, gx = np.mgrid[100:h - 79:40, 100:w - 101:60].astype(np.float64)
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])

    def moved(hm):
        q = hm @ p
        return q[:2] / q[2]

    ref = {f[0]: f for f in RECORDING_REF} if (h, w) == (720, 1282) else {}
    counts, worst_px, worst_vs_ref = [], 0.0, 0.0
    for t, res, r2, m, ok, plain in pairs:
        n, k = int(res.num_matches), int(res.num_inliers)
        counts.append([n, k])
        at = moved(res.h.double().cpu().numpy())
        worst_px = max(worst_px, float(np.abs(at - p[:2] - np.array(
            [[3.0 * t], [2.0 * t]])).max()))
        check(n > 100, f"frame {t}: {n} matches")
        if t in ref:
            # tests/test_torch_frontend.py's bars against the reference:
            # matches within 2 %, inliers within 3 %; H within 0.25 px of
            # the reference's (each of <= 3 % differing inliers of ~250
            # moves the refit by at most 5.5 px / 250)
            _, rn, rk, _, rh = ref[t]
            off = float(np.abs(at - moved(np.array(rh).reshape(3, 3))).max())
            worst_vs_ref = max(worst_vs_ref, off)
            check(abs(n - rn) <= 0.02 * rn and abs(k - rk) <= 0.03 * rk
                  and off <= 0.25, f"frame {t}: {n} matches, {k} inliers, "
                  f"H {off} px from the reference's ({rn}, {rk})")
        want = draw_matches(template_np, to_cpu(r1.keypoints),
                            np.roll(scene, (2 * t, 3 * t), (0, 1)),
                            to_cpu(r2.keypoints), to_cpu(m), ok.cpu())
        check(np.array_equal(plain, want),
              f"frame {t}: canvas != the CPU's draw of the card's results")
    return {"timer": timer, "wall_ms_per_frame": wall_ms / (frames - 1),
            "launches": launches, "k1_per_match_pair": per_pair[0],
            "counts": counts, "worst_shift_err_px": worst_px,
            "worst_h_vs_reference_px": worst_vs_ref,
            "held_to_reference": bool(ref),
            "frames_read": len(read_md5), "bytes_written":
            os.path.getsize(out), "template": template, "r1": r1,
            "kept": kept, "pair_step": pair_step}


class RecordingSink:
    """What run_live pushes into: it counts the frames and keeps the last,
    and passes each on to an MJPEG server where there is one."""

    def __init__(self, server=None):
        self.server, self.count, self.last = server, 0, None

    def push(self, frame: np.ndarray) -> None:
        self.count += 1
        self.last = frame
        if self.server is not None:
            self.server.push(frame)


def live_path(dev, frames: int = LIVE_FRAMES, width: int = 1280,
              height: int = 720) -> dict:
    """examples/live_demo.py's chain: SyntheticCamera -> run_live, whose
    process uploads the frame, runs the registry's ORB and draws the
    keypoints and a text line; pushed into RecordingSink and, where PIL
    imports, the port's MjpegServer on an ephemeral port, whose /snapshot
    is read back. The run ends by the camera's exhaustion."""
    import io as pyio
    import urllib.request

    from compv_tpu_torch import create_detector
    from compv_tpu_torch.io import SyntheticCamera
    from compv_tpu_torch.profiling import Timer
    from compv_tpu_torch.viz import (MjpegServer, draw_keypoints, draw_text,
                                     run_live)

    orb, cfg = create_detector("orb", max_features=2000, levels=8)
    timer = Timer()

    def process(frame: np.ndarray) -> np.ndarray:
        done = []
        with timer.section("upload_orb", block_on=done):
            res = orb(torch.from_numpy(frame).to(dev), cfg)
            done.append(res)
        with timer.section("draw"):
            canvas = draw_keypoints(frame, res.keypoints)
            draw_text(canvas, 4, 4, f"ORB KP {int(res.keypoints.count())}",
                      color=(0, 255, 0), background=(0, 0, 0))
        return canvas

    try:
        import PIL  # noqa: F401
        server = MjpegServer(port=0)
    except ImportError:
        server = None
    cam = SyntheticCamera(width, height, fps=30.0, n_frames=frames)
    sink = RecordingSink(server)
    torch.cuda.synchronize()
    reset_launch_counts()
    if server is not None:
        server.start()
    try:
        stats = run_live(cam, process, sink)
        torch.cuda.synchronize()
        launches = launch_counts()
        snapshot = None
        if server is not None:
            url = f"http://127.0.0.1:{server.port}/snapshot"
            with urllib.request.urlopen(url, timeout=30) as resp:
                jpg = resp.read()
            from PIL import Image
            snapshot = list(np.asarray(Image.open(pyio.BytesIO(jpg))).shape)
            check(jpg[:2] == b"\xff\xd8" and server.frames_pushed == frames,
                  f"MJPEG: {server.frames_pushed} pushed")
    finally:
        if server is not None:
            server.stop()
    check(stats["frames"] == frames and sink.count == frames,
          f"live path: {stats['frames']} frames, {sink.count} pushed")
    check(cam.finished.is_set() and not cam._running.is_set(),
          "live path not stopped by the camera's exhaustion")
    check(np.array_equal(sink.last, process(cam.frame_at(frames - 1))),
          "the last pushed frame != process(frame_at(last)) again")
    levels = orb_levels_used(height, width, cfg)
    check(launches["K1"] == frames * levels,
          f"live K1 launches {launches['K1']} != {frames} x {levels}")
    return {"stats": stats, "timer": timer, "launches": launches,
            "process": process, "camera": cam,
            "stream": ("MjpegServer on an ephemeral port, /snapshot "
                       f"{snapshot}") if server is not None else
            "RecordingSink only (PIL does not import here)"}


@contextlib.contextmanager
def k1_annotated():
    """Each K1 launch of the block inside a torch.profiler range of its
    own, "K1 launch <i> <h>x<w>"; yields the list of launched shapes."""
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    shapes, saved = [], (fk.fast_strengths_and_nms, fk.fast_strengths_nms)

    def wrap(fn):
        def annotated(img, *args, **kw):
            name = f"K1 launch {len(shapes)} {img.shape[0]}x{img.shape[1]}"
            shapes.append(tuple(img.shape))
            with torch.profiler.record_function(name):
                return fn(img, *args, **kw)
        return annotated

    fk.fast_strengths_and_nms, fk.fast_strengths_nms = map(wrap, saved)
    try:
        yield shapes
    finally:
        fk.fast_strengths_and_nms, fk.fast_strengths_nms = saved


def k1_window_audit(events: list, shapes: list, levels: int) -> dict:
    """Which K1 launches of phase 19's two-frame window the Chrome trace
    lacks, and in which stage: each launch's range ("K1 launch i") holds
    the runtime call that launched it; the device kernel with that call's
    correlation id is its trace. Stages of a frame, in order: match_pair's
    template ORB, its frame ORB, the drawing's frame ORB (``levels``
    launches each). Also every launch call of the window, of any kernel,
    whose kernel record is missing, with its time from the window's
    first event."""
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("K1 launch ")),
                    key=lambda e: e["ts"])
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and "aunch" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_corr = {e.get("args", {}).get("correlation"): e for e in kernels}

    def kernel_of(call):
        return by_corr.get(call.get("args", {}).get("correlation"))

    stages = ("match_pair template", "match_pair frame", "drawing frame")
    lost, in_ranges = [], 0
    for i, r in enumerate(ranges):
        mine = [e for e in calls
                if r["ts"] <= e["ts"] <= r["ts"] + r.get("dur", 0)]
        in_ranges += len(mine)
        traced = [k for k in map(kernel_of, mine) if k is not None]
        if not any("fast_kernel" in k.get("name", "") for k in traced):
            lost.append({
                "launch": i, "frame": i // (3 * levels) + 1,
                "stage": stages[(i % (3 * levels)) // levels],
                "level": i % levels, "shape": list(shapes[i]),
                "runtime_calls": [e.get("name") for e in mine],
                "kernels_by_correlation": [k.get("name") for k in traced]})
    t0 = min((e["ts"] for e in events if "ts" in e), default=0)
    orphans = [{"name": e.get("name"), "at_us": e["ts"] - t0,
                "correlation": e.get("args", {}).get("correlation")}
               for e in calls if kernel_of(e) is None]
    return {"launched": len(shapes), "ranges": len(ranges),
            "k1_kernels": sum("fast_kernel" in e.get("name", "")
                              for e in kernels),
            "runtime_launches_in_ranges": in_ranges, "lost": lost,
            "launch_calls": len(calls), "kernels": len(kernels),
            "launch_calls_without_kernel": len(orphans),
            "first_without_kernel": orphans[:8]}


def phase19_slice5(dev, scene: np.ndarray) -> dict:
    """Slice 5 at full width: the native runtime, config -> registry, the
    recording path, the live path, profiling on the card."""
    import tempfile

    from compv_tpu_torch import native_rt
    from compv_tpu_torch.ops.kernels._build import BUILD_DIR
    from compv_tpu_torch.profiling import Timer, device_memory_stats, trace

    lib = native_rt.library_path()
    check(native_rt.native_available() and lib.exists()
          and lib.parent == BUILD_DIR,
          f"native runtime not built by g++ under {BUILD_DIR}")
    with tempfile.TemporaryDirectory() as workdir:
        reg = config_and_registry(dev, scene, workdir)
        rec = recording_path(dev, scene, reg["cfg"], workdir)
        check(rec["held_to_reference"], "recording not held to RECORDING_REF")
        live = live_path(dev)
        # two frames of the recording path under trace(): its file names
        # K1 (a window without a device event is taken again, as
        # device_events does, up to three times)
        logdir = os.path.join(workdir, "trace")
        for _ in range(3):
            PROFILER["windows"] += 1
            with k1_annotated() as shapes, trace(logdir) as prof:
                for t, img in enumerate(rec["kept"][:2], 1):
                    rec["pair_step"](rec["template"], rec["r1"], img, t,
                                     Timer())
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
            names = [e.get("name", "") for e in events
                     if e.get("cat") == "kernel"]
            if names:
                break
            PROFILER["empty"] += 1
        k1_in_trace = sum("fast_kernel" in n for n in names)
        check(k1_in_trace > 0, "the trace names no K1 kernel")
        k1_window = k1_window_audit(events, shapes, orb_levels_used(
            *rec["template"].shape, reg["cfg"].orb))
    mem = device_memory_stats()
    check(len(mem) == 1 and mem[0]["bytes_in_use"] > 0,
          f"device_memory_stats: {mem}")
    emit({"phase": 19, "native": lib.name,
          "registry": reg["launches"], "yaml": reg["yaml"],
          "mser_round_trip": reg["mser_round_trip"],
          "recording": {"frames_read": rec["frames_read"],
                        "bytes_written": rec["bytes_written"],
                        "k1_per_match_pair": rec["k1_per_match_pair"],
                        "launches": rec["launches"],
                        "matches_inliers": rec["counts"],
                        "worst_shift_err_px": rec["worst_shift_err_px"],
                        "worst_h_vs_reference_px":
                            rec["worst_h_vs_reference_px"],
                        "canvases": "equal to the CPU's draw of the card's "
                                    "results"},
          "live": {"frames": live["stats"]["frames"],
                   "launches": live["launches"], "stream": live["stream"],
                   "stopped_by": "the camera's exhaustion",
                   "last_frame": "reproduced"},
          "trace": {"kernels": len(names), "k1_kernels": k1_in_trace,
                    "shortfall": prof.shortfall, "k1_window": k1_window},
          "memory": mem})
    return {"rec": rec, "live": live, "registry": reg["launches"]}


def phase20_slice5_times(card: str, s5: dict) -> dict:
    """The two demo paths' times: ms a frame by Timer stage (host clock
    around work that ends in a synchronize), the live loop's frames/s, and
    device busy, launches and idle share under torch.profiler over 4
    frames of each."""
    from compv_tpu_torch.profiling import Timer

    rec, live = s5["rec"], s5["live"]

    def stages(timer):
        return {k: timer.totals[k] / timer.counts[k] for k in timer.totals}

    rec_stages = stages(rec["timer"])
    live_stages = stages(live["timer"])
    rec_ms = sum(rec_stages.values())
    live_ms = sum(live_stages.values())
    rec_frames = iter(rec["kept"] * 2)
    live_frames = iter([live["camera"].frame_at(t) for t in range(5)])

    def rec_frame():
        rec["pair_step"](rec["template"], rec["r1"], next(rec_frames), 1,
                         Timer())

    def live_frame():
        live["process"](next(live_frames))

    out = {"phase": 20, "card": card,
           "recording_ms_per_frame_by_stage": rec_stages,
           "recording_ms_per_frame": rec_ms,
           "recording_wall_ms_per_frame": rec["wall_ms_per_frame"],
           "recording_profile": device_profile(
               rec_frame, rec_ms, 4, {"k1": "fast_kernel"}),
           "live_fps": live["stats"]["fps"],
           "live_ms_per_frame_by_stage": live_stages,
           "live_ms_per_frame": live_ms,
           "live_profile": device_profile(
               live_frame, live_ms, 4, {"k1": "fast_kernel"}),
           "timing": "Timer sections (host clock, each ending in a "
                     "synchronize of its results), mean over the run's "
                     "frames; frames/s of run_live includes the camera's "
                     "1/30 s sleep a frame; busy, launches and idle share "
                     "by torch.profiler over 4 frames (idle against the "
                     "Timer's ms a frame)"}
    emit(out)
    return out


DIST_FRAMES = 32          # phase 20's recording: the scene rolled by (2t, 3t)
DIST_RANKS = 2


def dist_ba_problem(dev):
    """tests/test_ba.py:254-287's scene at production scale: 256 cameras,
    20,000 landmarks, 100,000 observations (seed 11), observed at their
    true projections, landmarks then perturbed by 0.01."""
    from compv_tpu_torch.slam.ba import BAProblem, project_points

    rs = np.random.default_rng(11)
    f, l, o = 256, 20000, 100000
    cams = rs.normal(0, 0.05, (f, 6)).astype(np.float32)
    cams[:, 5] = 0.0
    lms = (rs.uniform(-2, 2, (l, 3)) + [0, 0, 6.0]).astype(np.float32)
    intr = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    ci = rs.integers(0, f, o).astype(np.int32)
    li = rs.integers(0, l, o).astype(np.int32)
    uv = project_points(*[torch.from_numpy(a).to(dev)
                          for a in (cams, lms, intr, ci, li)])
    lms_n = lms + rs.normal(0, 0.01, lms.shape).astype(np.float32)
    return BAProblem(*[torch.from_numpy(a).to(dev)
                       for a in (cams, lms_n, intr, ci, li)],
                     uv, torch.ones(o, dtype=torch.bool, device=dev))


def rank_phase21(mesh, frames, prob, k_schur, checkpoint):
    """One rank of phase 21: the distributed chain of
    examples/distributed_sfm.py on ``mesh`` (its stages timed between
    barriers), each BA step twice. Runs in a spawned process."""
    import torch.distributed as dist

    from compv_tpu_torch.features.orb import OrbConfig
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.parallel import _collectives, sharded
    from compv_tpu_torch.slam import sfm as ts
    from compv_tpu_torch.slam.ba import BAConfig
    from compv_tpu_torch.slam.ba_schur import SchurConfig

    torch.cuda.set_device(mesh.device)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        staged, k1 = _collectives.staged_bytes, fk.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        dist.barrier()
        stages[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                        "event_ms": start.elapsed_time(end),
                        "staged_bytes": _collectives.staged_bytes - staged,
                        "k1_launches": fk.launches - k1}
        return out

    fk.launches = 0
    imgs = torch.from_numpy(frames)
    orb = stage("sharded_orb_detect",
                lambda: sharded.sharded_orb_detect(imgs, mesh, OrbConfig()))
    desc, valid = orb.descriptors, orb.keypoints.valid
    all_pairs = stage("sharded_all_pairs_match",
                      lambda: sharded.sharded_all_pairs_match(desc, valid,
                                                              mesh))
    ring = stage("ring_all_pairs_match",
                 lambda: sharded.ring_all_pairs_match(desc, valid, mesh))
    lam = torch.tensor(1e-3, device=mesh.device)
    steps = {"psum": sharded.make_distributed_ba_step(mesh, BAConfig()),
             "reduce_scatter": sharded.make_distributed_ba_step(
                 mesh, BAConfig(), "reduce_scatter"),
             "schur": sharded.make_distributed_schur_step(
                 mesh, SchurConfig(), k_schur)}
    runs = {}
    for name, step in steps.items():
        runs[name] = []
        for i in range(2):
            p, lam1, cost = stage(f"ba_{name}_{i}", lambda: step(prob, lam))
            runs[name].append((p.cameras, p.landmarks, lam1, cost))
    resumed = stage("resume_sfm", lambda: ts.resume_sfm(
        checkpoint, sfm_128_config(), mesh=mesh))
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": torch.cuda.get_device_name(mesh.device),
            "orb": orb, "all_pairs": all_pairs, "ring": ring, "steps": runs,
            "resumed": resumed, "stages": stages, "k1": fk.launches}


def phase21_distributed(dev, card: str, scene: np.ndarray, sfm: dict) -> dict:
    """The distributed chain on two ranks of one card (gloo, staged through
    host memory; nccl, one rank a card, where there are two cards or
    more), each held to the single-process result on the card."""
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu_torch.parallel import launch, make_mesh, sharded
    from compv_tpu_torch.parallel.distributed import choose_backend
    from compv_tpu_torch.slam import sfm as ts
    from compv_tpu_torch.slam.ba import BAConfig, ba_residuals, ba_step
    from compv_tpu_torch.slam.ba_schur import (SchurConfig, ba_step_schur,
                                               max_obs_per_landmark)
    from compv_tpu_torch.slam.evaluate import ate_rmse

    t_phase = time.perf_counter()
    frames = np.stack([np.roll(scene, (2 * t, 3 * t), (0, 1))
                       for t in range(DIST_FRAMES)])
    ckpt = os.path.join(ROOT, "build", "sfm_128_checkpoints", "step_128.pt")
    check(os.path.exists(ckpt), f"no sfm_128 checkpoint at {ckpt}")
    prob = dist_ba_problem(dev)
    k = max_obs_per_landmark(prob.lm_idx, prob.valid,
                             prob.landmarks.shape[0])
    lam = torch.tensor(1e-3, device=dev)

    # single-process results on the card
    t0 = time.perf_counter()
    local = [orb_detect_describe(torch.from_numpy(f).to(dev), OrbConfig())
             for f in frames]
    m1 = make_mesh(1, device=dev)
    local_pairs = sharded.sharded_all_pairs_match(
        torch.stack([r.descriptors for r in local]),
        torch.stack([r.keypoints.valid for r in local]), m1)
    local_ba = ba_step(prob, lam, BAConfig())
    local_schur = ba_step_schur(prob, lam, SchurConfig(), max_obs_per_lm=k)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0

    backend = choose_backend(DIST_RANKS)
    # the ranks share the card with this process: hand back what its
    # allocator caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.spawn(rank_phase21, DIST_RANKS,
                         (frames, type(prob)(*[t.cpu() for t in prob]), k,
                          ckpt), timeout=900)
    spawn_s = time.perf_counter() - t0

    # every rank: the same backend, world, and bits
    for r, out in enumerate(ranks):
        check(out["backend"] == backend and out["world"] == DIST_RANKS,
              f"rank {r}: {out['backend']} of {out['world']}")
        check(out["stages"]["sharded_orb_detect"]["k1_launches"] > 0,
              f"rank {r}: K1 not launched by sharded_orb_detect")
        check(same_tree(out["orb"], ranks[0]["orb"]) and same_tree(
            out["steps"], ranks[0]["steps"]), f"rank {r} != rank 0")
    out = ranks[0]
    kp, desc = out["orb"]
    for t, want in enumerate(local):
        check(same_tree(tuple(f[t] for f in kp), to_cpu(want.keypoints))
              and same_tree(desc[t], want.descriptors.cpu()),
              f"frame {t}: sharded_orb_detect != orb_detect_describe")
    local_pairs = local_pairs.cpu()
    check(torch.equal(out["all_pairs"], local_pairs)
          and torch.equal(out["ring"], local_pairs)
          and out["all_pairs"].shape == (DIST_FRAMES, DIST_FRAMES)
          and not torch.diagonal(local_pairs).any(),
          "all-pairs / ring != the single-process matrix, or a non-zero "
          "diagonal")

    # BA: twice identical; against the single-process step
    steps = out["steps"]
    for name, runs in steps.items():
        check(same_tree(runs[0], runs[1]), f"ba {name}: two runs differ")

    def close(cams, want, rtol, atol):
        return bool(np.allclose(cams.numpy(), want.cpu().numpy(), rtol=rtol,
                                atol=atol))

    cams, _, _, cost = steps["psum"][0]
    lp, _, lcost = local_ba
    check(abs(float(cost) - float(lcost)) <= 1e-4 * abs(float(lcost))
          and close(cams, lp.cameras, 2e-3, 2e-4),
          "psum step != the single-process step")
    rs_cams, _, _, rs_cost = steps["reduce_scatter"][0]
    check(abs(float(rs_cost) - float(cost)) <= 1e-5 * abs(float(cost))
          and close(rs_cams, cams, 5e-3, 5e-4),
          "reduce_scatter step != the psum step")
    s_cams, s_lms, _, s_cost = steps["schur"][0]
    sp, _, scost = local_schur

    def cost_of(cams, lms):
        r = ba_residuals(cams.to(dev), lms.to(dev), prob)
        return float((r * r).sum())

    s_after = cost_of(s_cams, s_lms)
    l_after = cost_of(sp.cameras, sp.landmarks)
    check(abs(float(s_cost) - float(scost)) <= 1e-4 * abs(float(scost))
          and close(s_cams, sp.cameras, 2e-2, 1e-3)
          and abs(np.sqrt(s_after) - np.sqrt(l_after))
          <= 0.05 * np.sqrt(l_after) + 1e-3
          and s_after < 0.5 * float(s_cost),
          f"Schur step: cost {s_cost} -> {s_after} vs single-process "
          f"{scost} -> {l_after}")

    # resume on two ranks: phase 13's resume bar and the golden's
    g = load_golden("sfm_128.json")
    seq = g["sequence"]
    _, gt, _ = ts.render_orbit_sequence(seq["n_frames"], seq["h"], seq["w"],
                                        device=dev)
    res = out["resumed"]
    ate = float(ate_rmse(torch.tensor(res.positions, dtype=torch.float32),
                         torch.tensor(gt, dtype=torch.float32)))
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    direct = sfm["sfm_128_480p_schur"]["ate"]
    check(ate <= max(1.5 * direct, 0.03 * span),
          f"resume_sfm on {DIST_RANKS} ranks: ATE {ate} vs direct {direct}")
    bars = sfm_bars(ate, res, gt, g, "sfm_128.json resumed on 2 ranks",
                    span_pct=2.5)
    phase_s = time.perf_counter() - t_phase
    row = {"phase": 21, "card": card, "backend": backend,
           "world_size": DIST_RANKS, "ranks_on": out["device"],
           "frames": f"{DIST_FRAMES} x {scene.shape[0]}x{scene.shape[1]}, "
                     "OrbConfig() (2,000 features, 8 levels)",
           "ba_scene": "256 cameras, 20,000 landmarks, 100,000 "
                       "observations, seed 11",
           "k1_launches_by_rank": [r["stages"]["sharded_orb_detect"][
               "k1_launches"] for r in ranks],
           "stages_by_rank": [r["stages"] for r in ranks],
           "staged_bytes_by_rank": [sum(s["staged_bytes"] for s in
                                        r["stages"].values()) for r in ranks],
           "ba": {"psum_cost": float(cost), "single_cost": float(lcost),
                  "reduce_scatter_cost": float(rs_cost),
                  "schur_cost_before": float(s_cost),
                  "schur_cost_after": s_after,
                  "single_schur_cost_after": l_after,
                  "two_runs": "bit-identical"},
           "resumed": {**bars, "direct_ate": direct},
           "single_process_s": local_s, "spawn_s": spawn_s,
           "phase_s": phase_s,
           "timing": "stages: host clock and CUDA events between barriers "
                     "of both ranks (each rank's own stream); spawn_s: "
                     "spawn, group bring-up and every stage"}
    emit(row)
    return row

# ---------------------------------------------------------------- phase 22

# examples_torch/'s programs, in the order phase 22 runs them as programs:
# (name, arguments on the card, seconds allowed)
EXAMPLES_RUNS = (
    ("edge_lines", (), 300),
    ("planar_tracking", (), 300),
    ("object_recognition", (), 300),
    ("camera_calibration", (), 300),
    ("live_demo", ("--seconds", LIVE_DEMO_SECONDS, "--port", "0"), 300),
    ("distributed_sfm", (), 300),
    ("distributed_sfm", ("--ranks", "2"), 300),
)
# what each single-process program writes, by name
EXAMPLES_FILES = {
    "edge_lines": ("edges.png", "hough_lines.png"),
    "planar_tracking": (),
    "object_recognition": ("object_recognition_matches.png",
                           "object_recognition.gif"),
    "camera_calibration": ("calibration_view.png",
                           "calibration_undistorted.png"),
    "live_demo": (),
}
# What the reference's programs print, and the full-precision values behind
# the rounded numbers, on the CPU (JAX, 8 virtual devices for
# distributed_sfm): the output of python3 scripts/examples_reference.py
EXAMPLES_REF = json.loads("""{
"edge_lines": {"printed": {"canny_pixels": 488, "sht_count": 4, "sht":
[[96.0, 115.0, 127.0], [-14.0, 115.0, 126.0], [116.0, 25.0, 78.0], [276.0,
25.0, 78.0]], "kht_count": 6, "wrote": ["hough_lines.png"]}, "precise": {}},
"planar_tracking": {"printed": {"tracked": [true, true, true, true, true,
true], "inliers": [0, 726, 747, 722, 721, 707], "ate": 0.049, "wrote": []},
"precise": {"h_to_first": [[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0,
1.0]], [[1.00005102, 0.00101810088, 3.91801596], [-0.000109018445,
1.00064635, 1.98126066], [-8.63656794e-07, 4.05442552e-06, 1.0]],
[[1.00113174, 0.00108050349, 7.85829975], [0.000105708244, 1.00130385,
4.95917105], [2.02468267e-06, 5.20679152e-06, 1.0]], [[1.00010957,
0.000881987232, 11.9000241], [-0.000288621991, 1.00081467, 6.97726185],
[-1.59036849e-06, 4.2571148e-06, 1.0]], [[0.999856706, 0.000821777994,
15.8900252], [-0.00023599564, 1.00040677, 9.97299032], [-1.89266823e-06,
1.78702253e-06, 1.0]], [[0.999706216, 0.0014321264, 19.8467722],
[-0.000419786988, 1.00062073, 11.9729141], [-2.71158952e-06, 3.12259986e-06,
1.0]]], "ate": 0.0492774844}},
"object_recognition": {"printed": {"kp1": 512, "kp2": 512, "matches": 218,
"inliers": 218, "h": [0.9505, 0.0798, 30.0134, -0.0496, 1.0192, 12.0451,
0.0, -0.0, 1.0], "h_true": [0.95, 0.08, 30.0, -0.05, 1.02, 12.0, 0.0, -0.0,
1.0], "wrote": ["object_recognition_matches.png",
"object_recognition.gif"]}, "precise": {"h": [[0.950512767, 0.0798281133,
30.0134277], [-0.0496237427, 1.01920652, 12.045105], [1.32635241e-05,
-2.28566623e-05, 1.0]], "inliers_by_frame": [512, 329, 309, 309, 277, 259,
270, 236, 229, 218]}},
"camera_calibration": {"printed": {"detected": [true, true, false, true,
true], "fx": 683.9, "fy": 688.6, "cx": 342.4, "cy": 251.1, "dist": [0.2233,
-7.4737, 0.0, 0.0], "rms": 0.45, "rms_initial": 0.513, "wrote":
["calibration_undistorted.png"]}, "precise": {"k": [[683.864624, 0.0,
342.441193], [0.0, 688.584106, 251.079498], [0.0, 0.0, 1.0]], "dist":
[0.223263323, -7.47369146, 0.0, 0.0], "rms": 0.450493336, "rms_initial":
0.513180554}},
"distributed_sfm": {"printed": {"devices": 8, "sim_row": [0.0, 3.8, 5.9,
7.2, 8.3, 11.4], "rmse_before": 2.9, "rmse_after": 0.001, "wrote": []},
"precise": {"rmse_before": 2.89972448, "rmse_after": 0.000716160226}}
}""")


@functools.lru_cache(maxsize=None)
def examples_module():
    """scripts/examples_reference.py (its parser and in-process runner of
    the port's programs; it imports no JAX unless asked to run a reference
    program, which this script never does)."""
    return load_by_path("examples_reference", os.path.join(
        "scripts", "examples_reference.py"))


def grid_points(h: int, w: int, step: int = 20) -> np.ndarray:
    gy, gx = np.mgrid[step:h - step + 1:step,
                      step:w - step + 1:step].astype(np.float64)
    return np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])


def projection_gap(h1, h2, p: np.ndarray) -> float:
    """Largest distance between where two homographies move the points."""
    def at(h):
        q = np.asarray(h, np.float64).reshape(3, 3) @ p
        return q[:2] / q[2]
    return float(np.abs(at(h1) - at(h2)).max())


# camera_calibration's k2 on the card, relative to the reference's. Its four
# detected views (no distortion in truth) leave k2 nearly free: 1e-4 px of
# noise on the corners moves it by up to 0.8 %, far past the CPU tests' 5e-3
# (tests/test_torch_examples_lines_calib.py::
# test_calibration_k2_is_ill_conditioned), so k1, p1 and p2 are held to
# 5e-3 and k2 to what its conditioning allows
K2_REL = 0.01


def hold_printed(name: str, got: dict, args=()) -> dict:
    """A program's printed numbers against the reference's (EXAMPLES_REF),
    by the CPU tests' bars (tests/test_torch_examples_*.py); returns what
    was compared."""
    if name == "live_demo":     # the reference serves until its time is up
        check(got["frames"] > 0 and got["port"] > 0,
              f"live_demo printed {got}")
        return {}
    want = EXAMPLES_REF[name]["printed"]
    check(got["wrote"] == want["wrote"],
          f"{name} wrote {got['wrote']}, the reference {want['wrote']}")
    gap = {}

    def close(a, b, rel):
        return abs(a - b) <= rel * b

    if name == "edge_lines":
        check(got == want, f"edge_lines printed {got}, reference {want}")
    elif name == "planar_tracking":
        check(got["tracked"] == want["tracked"],
              f"planar_tracking tracked {got['tracked']}")
        check(all(close(g, w, 0.03) for g, w in
                  zip(got["inliers"], want["inliers"], strict=True)),
              f"planar_tracking inliers {got['inliers']} vs "
              f"{want['inliers']}")
        gap["ate_px"] = abs(got["ate"] - want["ate"])
        check(gap["ate_px"] <= 0.05 + 1e-3, f"planar_tracking ATE {got}")
    elif name == "object_recognition":
        check((got["kp1"], got["kp2"]) == (want["kp1"], want["kp2"])
              and close(got["matches"], want["matches"], 0.02)
              and close(got["inliers"], want["inliers"], 0.03)
              and got["h_true"] == want["h_true"],
              f"object_recognition printed {got}, reference {want}")
        p = grid_points(240, 320)
        gap["h_px"] = projection_gap(got["h"], want["h"], p)
        check(gap["h_px"] <= 0.05 + 1e-4 * np.abs(p).sum(axis=0).max(),
              f"object_recognition printed H {gap['h_px']} px off")
    elif name == "camera_calibration":
        check(got["detected"] == want["detected"] ==
              [True, True, False, True, True],
              f"camera_calibration detected {got['detected']}")
        scale = max(abs(want[k]) for k in ("fx", "fy", "cx", "cy"))
        d, wd = np.asarray(got["dist"]), np.asarray(want["dist"])
        check(all(abs(got[k] - want[k]) <= 1e-3 * scale + 0.1
                  for k in ("fx", "fy", "cx", "cy"))
              and np.abs(np.delete(d - wd, 1)).max() <= 5e-3 + 1e-4
              and abs(d[1] - wd[1]) <= K2_REL * abs(wd[1]) + 1e-4
              and abs(got["rms"] - want["rms"]) <= 1e-3 * want["rms"] + 1e-3
              and abs(got["rms_initial"] - want["rms_initial"])
              <= 5e-3 * want["rms_initial"] + 1e-3,
              f"camera_calibration printed {got}, reference {want}")
    elif name == "distributed_sfm":
        ranks = int(args[args.index("--ranks") + 1]) if "--ranks" in args \
            else torch.cuda.device_count()
        check(got["devices"] == ranks, f"distributed_sfm mesh {got}")
        check(got["sim_row"] == want["sim_row"][:2 * ranks]
              and got["rmse_before"] == want["rmse_before"],
              f"distributed_sfm printed {got}, reference {want}")
        gap["rmse_after_px"] = abs(got["rmse_after"] - want["rmse_after"])
        check(gap["rmse_after_px"] <= max(0.05 * want["rmse_after"], 1e-3)
              + 1e-3, f"distributed_sfm RMSE after BA {got['rmse_after']}")
    return gap


def hold_precise(name: str, result: dict) -> dict:
    """An in-process run's full-precision results against EXAMPLES_REF's
    (the reference's recorded calls), by the CPU tests' bars."""
    want = EXAMPLES_REF.get(name, {}).get("precise")
    er = examples_module()
    calls = er.plain(result)
    got = er.precise(name, calls) if want else {}
    gap = {}
    if name == "planar_tracking":
        p = grid_points(200, 280)
        gap["h_px"] = max(projection_gap(g, w, p) for g, w in
                          zip(got["h_to_first"], want["h_to_first"],
                              strict=True))
        gap["ate_px"] = abs(got["ate"] - want["ate"])
        check(gap["h_px"] <= 0.05 and gap["ate_px"] <= 0.05,
              f"planar_tracking against the reference: {gap}")
    elif name == "object_recognition":
        p = grid_points(240, 320)
        gap["h_px"] = projection_gap(got["h"], want["h"], p)
        check(gap["h_px"] <= 0.05, f"object_recognition H {gap} off")
        check(all(abs(g - w) <= 0.03 * w for g, w in
                  zip(got["inliers_by_frame"], want["inliers_by_frame"],
                      strict=True)),
              f"object_recognition frames' inliers {got} vs {want}")
    elif name == "camera_calibration":
        k, wk = np.asarray(got["k"]), np.asarray(want["k"])
        gap["k_rel"] = float(np.abs(k - wk).max() / np.abs(wk).max())
        d, wd = np.asarray(got["dist"]), np.asarray(want["dist"])
        gap["dist_k1_p1_p2"] = float(np.abs(np.delete(d - wd, 1)).max())
        gap["dist_k2_rel"] = float(abs(d[1] - wd[1]) / abs(wd[1]))
        check(gap["k_rel"] <= 1e-3 and gap["dist_k1_p1_p2"] <= 5e-3
              and gap["dist_k2_rel"] <= K2_REL
              and abs(got["rms"] - want["rms"]) <= 1e-3 * want["rms"]
              and abs(got["rms_initial"] - want["rms_initial"])
              <= 5e-3 * want["rms_initial"],
              f"camera_calibration against the reference: {got}")
    return gap


def expected_launches(name: str, result: dict) -> dict:
    """The hand kernels' launches one run of a program makes: K1 and the
    orientation kernel (K6) once each for each pyramid level ORB runs on
    (orb_levels_used) of each image it describes, K4 once a hough_sht
    (edge_lines) and once a view (find_chessboard_corners)."""
    from compv_tpu_torch.features.orb import OrbConfig

    zero = {k: 0 for k in launch_counts()}

    def orb(n):
        return {**zero, "K1": n, "K6": n}

    if name == "edge_lines":
        return {**zero, "K4": 1}
    if name == "camera_calibration":
        return {**zero, "K4": 5}
    if name == "planar_tracking":
        return orb(6 * orb_levels_used(
            200, 280, OrbConfig(max_features=1000, levels=4)))
    if name == "object_recognition":
        # 11 match_pair (2 images each) and the two ORB calls of the drawing
        return orb((2 * 11 + 2) * orb_levels_used(
            240, 320, OrbConfig(max_features=512, levels=3)))
    if name == "live_demo":
        return orb(result["frames_drawn"] * orb_levels_used(
            480, 640, OrbConfig(max_features=256, levels=3)))
    raise ValueError(name)


def image_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels (of all channels) that differ between two decoded images."""
    check(a.shape == b.shape, f"image shapes {a.shape} != {b.shape}")
    return int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).sum())


def decoded_frames(path: str) -> list:
    from PIL import Image, ImageSequence

    return [np.asarray(f.convert("RGB"))
            for f in ImageSequence.Iterator(Image.open(path))]


def phase22_examples(dev, card: str) -> dict:
    """examples_torch/'s six programs: each as a program on the card (its
    printed numbers held to EXAMPLES_REF, its wall seconds), each
    single-process one again here with the hand kernels' counts read
    around its main() (held to expected_launches, its precise results to
    EXAMPLES_REF) and once more on the CPU, whose files the card run's are
    compared with."""
    import gc
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()    # the programs share the card with this one
    er = examples_module()
    out_dir = os.path.join(ROOT, "examples_torch", "out")
    rows, card_files = [], {}
    for name, args, limit in EXAMPLES_RUNS:
        files = EXAMPLES_FILES.get(name, ())
        for f in files:
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(out_dir, f))
        cmd = [sys.executable, os.path.join(ROOT, "examples_torch",
                                            f"{name}.py"), *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=limit)
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"examples_torch/{name}.py {' '.join(args)} exited "
              f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        printed = er.parse(name, proc.stdout)
        gap = hold_printed(name, printed, args)
        card_files[name] = {f: os.path.join(out_dir, f) for f in files}
        check(all(map(os.path.exists, card_files[name].values())),
              f"{name}: a file of {files} is missing from {out_dir}")
        row = {"phase": 22, "program": f"examples_torch/{name}.py",
               "args": list(args), "seconds": round(seconds, 3),
               "card": card, "printed": printed,
               "against_reference": gap or "as printed"}
        rows.append(row)
        emit(row)

    checked = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES_FILES:
            args = ("--seconds", "2", "--port", "0") \
                if name == "live_demo" else ()
            torch.cuda.synchronize()
            reset_launch_counts()
            _, on_card = er.run_port(name, args, os.path.join(tmp, "card"))
            torch.cuda.synchronize()
            launches = launch_counts()
            want = expected_launches(name, on_card)
            check(launches == want,
                  f"{name}: hand kernel launches {launches} != {want}")
            gap = hold_precise(name, on_card)
            _, on_cpu = er.run_port(name, (*args, "--device", "cpu"),
                                    os.path.join(tmp, "cpu"))
            images = {}
            for f, path in card_files[name].items():
                a = decoded_frames(path)
                b = decoded_frames(os.path.join(tmp, "cpu", f))
                check(len(a) == len(b), f"{f}: {len(a)} frames, CPU {len(b)}")
                images[f] = [image_gap(x, y) for x, y in zip(a, b)]
            if name == "live_demo":
                images["last_frame"] = [live_frame_gap(on_card)]
            if name == "camera_calibration":
                images.update(calibration_ops_gap(dev, on_cpu,
                                                  os.path.join(tmp, "cpu")))
            # bit-equal on the card where the CPU port is bit-equal to the
            # reference (tests/test_torch_examples_*.py), and the warp and
            # the undistortion on the CPU run's H, K and dist; the
            # program's own GIF, view and undistorted image differ by the
            # outline and border pixels that the card's H, K and dist move
            # (5, 358 and 3,874-5,436 pixels on an H100 against its CPU)
            for f, gaps in images.items():
                limit = {"calibration_view.png": 0.002 * 500 * 660,
                         "calibration_undistorted.png": 0.05 * 400 * 480,
                         "object_recognition.gif": 0.001 * 240 * 320}.get(
                    f, 0)
                check(max(gaps) <= limit,
                      f"{name}: {f} differs from the CPU run in {gaps} "
                      f"pixels (limit {limit})")
            checked[name] = {"launches": {k: v for k, v in launches.items()
                                          if v}, "against_reference": gap,
                             "pixels_differing_from_cpu": images}
            emit({"phase": 22, "in_process": name, **checked[name]})
    return {"programs": rows, "in_process": checked}


def calibration_ops_gap(dev, on_cpu: dict, cpu_dir: str) -> dict:
    """camera_calibration's two image operations on the card, fed the CPU
    run's view-2 homography and its K and dist: pixels that differ from the
    CPU run's files (the CPU port's are the reference's on the reference's
    parameters)."""
    from PIL import Image

    from compv_tpu_torch.calib.utils import undistort_image
    from compv_tpu_torch.image import warp_perspective

    base, _ = examples_module().load_port("camera_calibration").render_board(
        6, 8, 40)
    tb = torch.from_numpy(base).to(dev)
    h_inv = np.linalg.inv(on_cpu["compute_homography_dlt"][2])
    view = warp_perspective(tb, torch.from_numpy(h_inv).to(dev), 500, 660,
                            fill=128.0).cpu().numpy()
    res = on_cpu["calibrate_camera"][0]
    und = undistort_image(tb, res.k.to(dev), res.dist.to(dev)).cpu().numpy()

    def png(name):
        return np.asarray(Image.open(os.path.join(cpu_dir, name)))
    return {"view_from_cpu_h": [image_gap(view, png("calibration_view.png"))],
            "undistorted_from_cpu_k": [image_gap(
                und, png("calibration_undistorted.png"))]}


def live_frame_gap(result: dict) -> int:
    """Pixels in which live_demo's last frame on the card differs from the
    same camera frame's ORB and drawing on the CPU."""
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu_torch.io.camera import SyntheticCamera
    from compv_tpu_torch.viz import draw_keypoints, draw_text

    n = result["frames_drawn"]
    frame = SyntheticCamera(width=640, height=480).frame_at(n - 1)
    res = orb_detect_describe(torch.from_numpy(frame),
                              OrbConfig(max_features=256, levels=3))
    want = draw_text(draw_keypoints(frame, res.keypoints), 4, 4,
                     f"frame {n}  kp {int(res.keypoints.valid.sum())}")
    return image_gap(result["last"], want)


# ---------------------------------------------------------------- phase 23

# The hand kernels that one call of each bench_torch.py row launches on the
# card; every row not named launches none. mser_text: K2b and K7 on the 49
# changed levels of the text scene's ladder (phase 7's count).
BENCH_LAUNCHES = {
    "fast9_nms_detect_fps_1282x720": {"K1": 1},
    "frontend_pair_720p": {"K1": 16, "K6": 16},
    "ccl_label_text": {"K2a": 1},
    "ccl_boxes_text": {"K3": 1},
    "mser_text": {"K2b": 49, "K7": 49},
    "hough_sht": {"K4": 1},
}
# accumulators, card against the CPU: float sums in another order (HOG's
# 2.4M values, the homography's entries)
BENCH_ACC_REL = 1e-3
BENCH_TARGET_DIFF = "0.02"      # 0.05 before the cuts of the depth table


def bench_lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


def phase23_bench(dev, card: str) -> dict:
    """bench_torch.py as a program on the card at a short --target-diff,
    beside its --once run on the CPU: every row's line naming the card, no
    error line, rc 0, each row's checksum equal to the CPU's (accumulators
    within BENCH_ACC_REL) and its hand kernels as BENCH_LAUNCHES; then
    each row's call here under CUDA events and the profiler, and
    scripts/roofline_torch.py's K1, K2a and K4 rows, each share at most
    100 %."""
    import gc

    bt = load_by_path("bench_torch", "bench_torch.py")
    gc.collect()
    torch.cuda.empty_cache()    # the program shares the card with this one
    script = os.path.join(ROOT, "bench_torch.py")
    t0 = time.perf_counter()
    # the CPU's checksums meanwhile, on the cores the card's run leaves
    cpu_run = subprocess.Popen(
        [sys.executable, script, "--device", "cpu", "--once"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "6"})
    try:
        proc = subprocess.run(
            [sys.executable, script, "--target-diff", BENCH_TARGET_DIFF],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        cpu_out, cpu_err = cpu_run.communicate(timeout=600)
    finally:
        if cpu_run.poll() is None:
            cpu_run.kill()
            cpu_run.wait()
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"bench_torch.py exited {proc.returncode}:\n{proc.stdout[-3000:]}"
          f"\n{proc.stderr[-3000:]}")
    check(cpu_run.returncode == 0,
          f"bench_torch.py --device cpu --once exited {cpu_run.returncode}:"
          f"\n{cpu_out[-3000:]}\n{cpu_err[-3000:]}")
    lines = bench_lines(proc.stdout)
    names = [name for name, _ in bt.REF_FPS]
    check([line["metric"] for line in lines]
          == names + ["suite_geomean_vs_reference"],
          f"bench_torch.py printed {[line['metric'] for line in lines]}")
    check(all(line.get("device") == card and "error" not in line
              for line in lines), "a bench_torch.py line has an error or "
          "does not name the card")
    on_cpu = {line["metric"]: line for line in bench_lines(cpu_out)}
    check(list(on_cpu) == names, f"--once printed {list(on_cpu)}")
    rows = {}
    for line in lines[:-1]:
        name, cpu = line["metric"], on_cpu[line["metric"]]
        check(line["checksum"] == cpu["checksum"],
              f"{name}: checksum {line['checksum']} on the card, "
              f"{cpu['checksum']} on the CPU")
        rel = abs(line["acc"] - cpu["acc"]) / max(abs(cpu["acc"]), 1e-30)
        check(rel <= BENCH_ACC_REL,
              f"{name}: accumulator {line['acc']} on the card, {cpu['acc']} "
              f"on the CPU ({rel} relative)")
        want = BENCH_LAUNCHES.get(name, {})
        check(line["launches"] == want,
              f"{name}: hand kernels {line['launches']} != {want}")
        rows[name] = {"fps": line["value"], "vs_baseline":
                      line["vs_baseline"], "ms": line["ms"],
                      "event_ms": line["event_ms"], "acc_rel_err": rel,
                      "launches": line["launches"],
                      **({"method": line["method"]} if "method" in line
                         else {})}

    # each row's call here, back to back and under the profiler: device
    # busy, launches and idle share a call
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in bt.inputs(*bt._images()).items()}
    for name, arr, fn, _ in bt.rows(inp):
        arr = arr() if callable(arr) else arr
        ms = cuda_ms(lambda: fn(arr), reps=TIMING_REPS["bench_here"])
        rows[name]["here"] = {"ms": ms, **device_profile(lambda: fn(arr), ms)}
    del inp

    rf = load_by_path("roofline_torch", os.path.join("scripts",
                                                     "roofline_torch.py"))
    roof = rf.measure(["fast9", "ccl", "hough"], dev,
                      rf.PEAKS[torch.cuda.get_device_name(0)], 0.1)
    check([r["name"] for r in roof] == [rf.ROWS[0], rf.ROWS[3], rf.ROWS[4]],
          f"roofline rows {[r['name'] for r in roof]}")
    for r in roof:
        check(0 < r["share"] <= 1, f"{r['name']}: share {r['share']}")
    out = {"phase": 23, "card": card, "rows": rows,
           "geomean": lines[-1], "seconds": round(seconds, 3),
           "roofline": [{k: r[k] for k in ("name", "ms", "event_ms",
                                           "bound_ms", "bound_by", "share",
                                           "launches")} for r in roof],
           "bars": "29 rows and the geomean naming the card, rc 0; "
                   "checksums equal to the CPU's --once run, accumulators "
                   f"within {BENCH_ACC_REL} relative; hand kernels as "
                   "BENCH_LAUNCHES; roofline shares at most 100 %",
           "timing": f"bench_torch.py --target-diff {BENCH_TARGET_DIFF} "
                     "(the CPU run beside it); here: the median of 5 "
                     "CUDA-event timings of a call after two warm-up calls, "
                     "busy, launches and idle share by torch.profiler over "
                     "3 calls"}
    emit(out)
    return out


def trace_probe() -> int:
    """Windows of torch.profiler around K1 launches, each counted against
    K1's launch counter: raw windows opened with and without a synchronize
    before them, and profiling.trace windows, of 1 and of 30 launches, in
    a fresh process and again after a few hundred windows and a load of
    other work; prints, per kind, the K1 kernels each window held."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu_torch.ops.kernels import fast_kernel as fk
    from compv_tpu_torch.profiling import trace

    dev, card = phase1_device_and_build()
    img = torch.from_numpy(scenes()[0]).to(dev)
    fk.fast_strengths_and_nms(img, 20, 9)
    torch.cuda.synchronize()
    logdir = os.path.join(ROOT, "build", "trace_probe")

    def raw(launches, sync_before, activities=(ProfilerActivity.CUDA,)):
        if sync_before:
            torch.cuda.synchronize()
        with profile(activities=list(activities)) as prof:
            for _ in range(launches):
                fk.fast_strengths_and_nms(img, 20, 9)
            torch.cuda.synchronize()
        return sum("fast_kernel" in e.name()
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)

    in_file = []

    def traced(launches):
        """K1 kernels the window held by trace()'s own count; what its
        Chrome trace file names goes to in_file."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with trace(logdir) as prof:
                for _ in range(launches):
                    fk.fast_strengths_and_nms(img, 20, 9)
        with open(prof.trace_path) as f:
            in_file.append(sum(
                e.get("cat") == "kernel" and "fast_kernel" in e.get("name", "")
                for e in json.load(f)["traceEvents"]))
        os.remove(prof.trace_path)
        short = prof.shortfall.get("fast_kernel")
        return launches if short is None else short[1]

    out = {"card": card}
    t0 = time.perf_counter()
    for when in ("fresh", "late"):
        for kind, fn in (("raw_no_sync_before", lambda n: raw(n, False)),
                         ("raw_sync_before", lambda n: raw(n, True)),
                         ("raw_cpu_cuda", lambda n: raw(n, True, (
                             ProfilerActivity.CPU, ProfilerActivity.CUDA))),
                         ("trace", traced)):
            for n, windows in ((1, 100), (30, 20)):
                in_file.clear()
                held = [fn(n) for _ in range(windows)]
                out[f"{when}_{kind}_{n}"] = {
                    "windows": windows, "short": sum(h < n for h in held),
                    "held_min": min(held), "held_total": sum(held),
                    **({"file_short": sum(h < n for h in in_file)}
                       if in_file else {})}
        if when == "fresh":      # a load of other work and windows
            for _ in range(200):
                raw(1, True)
            for _ in range(20):
                orb_detect_describe(img, OrbConfig())
            torch.cuda.synchronize()
    out["probe_s"] = time.perf_counter() - t0
    emit({"trace_probe": out})
    return 0

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


def phase24_sweep(dev) -> dict:
    """The differential sweep on the card: every case of
    tests/test_torch_parity_cases.py (loaded by path: it imports numpy and
    torch only) through the port on the card and on the CPU, held to each
    other by the case's rule (the same exception class; else the same
    structure, dtypes and shapes, integers bit-equal, floats within the
    case's tolerance); a case of CARD_FAULTS must still differ. Counts by
    module and by dtype."""
    pc = load_by_path("compv_parity_cases",
                      os.path.join("tests", "test_torch_parity_cases.py"))
    by_module, by_dtype, failures, raised = {}, {}, [], 0
    known, n = {}, 0
    for group in pc.GROUPS:
        for case in pc.cases(group):
            n += 1
            cpu = pc.run_port(case, "cpu")
            card = pc.run_port(case, dev)
            diff = pc.compare(cpu, card, case)
            kind = case.axis.split(",")[0]
            kind = kind if kind in pc.DTYPES else "shape"
            for table, key in ((by_module, case.module), (by_dtype, kind)):
                agree, total = table.get(key, (0, 0))
                table[key] = (agree + (not diff), total + 1)
            raised += cpu[0] == "raise" and not diff
            if case.id in pc.CARD_FAULTS:     # known, and must still show
                known[case.id] = diff[:3]
                diff = [] if diff else ["no longer differs: drop its "
                                        "CARD_FAULTS entry"]
            if diff:
                failures.append({"case": case.id, "diff": diff[:3]})
    torch.cuda.synchronize(dev)
    out = {"phase": 24, "cases": n,
           "agree": n - len(failures) - len(known),
           "both_raise": raised, "card_faults": known,
           "by_module": {k: list(v) for k, v in sorted(by_module.items())},
           "by_dtype": {k: list(v) for k, v in sorted(by_dtype.items())},
           "failures": failures[:40]}
    emit(out)
    check(not failures, f"phase 24: {len(failures)} of {n} cases differ "
          f"between the card and the CPU: {failures[:5]}")
    return out


PHASE_S = {}


def timed(number: int, fn, *args):
    """Run phase ``number`` and print its wall seconds on a line of its
    own."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[number] = round(time.perf_counter() - t0, 3)
    emit({"phase_s": {"phase": number, "s": PHASE_S[number]}})
    return out


def main() -> int:
    root = ROOT
    if "--package-root" in sys.argv:
        root = sys.argv[sys.argv.index("--package-root") + 1]
    if "--text-kernel-times" in sys.argv[1:]:
        return text_kernel_times(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--trace-probe" in sys.argv[1:]:
        sys.path.insert(0, ROOT)
        return trace_probe()
    if "--distributed" in sys.argv[1:]:
        # phase 21 alone, after the 128-frame run that writes its checkpoint
        sys.path.insert(0, ROOT)
        dev, card = phase1_device_and_build()
        phase21_distributed(dev, card, scenes()[0], {
            "sfm_128_480p_schur": sfm_128_run(dev, resume=True)})
        return 0
    if "--examples" in sys.argv[1:]:
        # phase 22 alone
        sys.path.insert(0, ROOT)
        phase22_examples(*phase1_device_and_build())
        return 0
    if "--bench" in sys.argv[1:]:
        # phase 23 alone
        sys.path.insert(0, ROOT)
        phase23_bench(*phase1_device_and_build())
        return 0
    if "--orient" in sys.argv[1:]:
        # phase 25 alone
        sys.path.insert(0, ROOT)
        dev, card = phase1_device_and_build()
        timed(25, phase25_orient_kernel, dev, card, scenes()[0])
        return 0
    if "--level-areas" in sys.argv[1:]:
        # phase 26 alone
        sys.path.insert(0, ROOT)
        dev, card = phase1_device_and_build()
        timed(26, phase26_level_areas, dev, card, scenes()[1])
        return 0
    if "--sweep" in sys.argv[1:]:
        # phase 24 alone
        sys.path.insert(0, ROOT)
        dev, _ = phase1_device_and_build()
        timed(24, phase24_sweep, dev)
        return 0
    if "--sfm-128" in sys.argv[1:]:
        # the 128-frame golden run alone, from the package under root
        sys.path.insert(0, root)
        from compv_tpu_torch.device import require_cuda

        emit({"package_root": os.path.abspath(root), "card": card_line(),
              "sfm_128_480p_schur": sfm_128_run(require_cuda(), False)})
        return 0
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    dev, card = timed(1, phase1_device_and_build)
    scene, text = scenes()
    err = timed(2, phase2_kernel_vs_twin, dev, scene)
    timed(3, phase3_goldens, dev)
    cfg, img1, img2, k1_launches = timed(4, phase4_slice, dev, scene)
    k1_times, k1_bound = timed(5, phase5_times, dev, card, cfg, img1, img2)
    timed(25, phase25_orient_kernel, dev, card, scene)
    pairs, labels = timed(6, phase6_ccl_kernels_vs_twins, dev, text)
    text_bin, img, labels, launches = timed(7, phase7_text_slice, dev, text,
                                            len(pairs))
    times, bounds = timed(8, phase8_text_times, card, text_bin, img, labels,
                          pairs, launches)
    timed(26, phase26_level_areas, dev, card, text)
    k45_err = timed(9, phase9_hough_kernels_vs_twins, dev, scene, text,
                    pairs, labels)
    gray, edges, board, launches["K4"], launches["K5"] = timed(
        10, phase10_hough_slice, dev, scene, text)
    k45_times, k45_bounds = timed(11, phase11_hough_times, card, gray, edges,
                                  board, labels)
    timed(12, phase12_sfm_components, dev)
    sfm = timed(13, phase13_sfm_slice, dev)
    timed(14, phase14_sfm_times, dev, card, sfm.pop("sfm_32_480p_run"))
    s3 = timed(15, phase15_slice3, dev, scene)
    timed(16, phase16_slice3_times, card, s3)
    s4 = timed(17, phase17_slice4, dev, scene)
    timed(18, phase18_slice4_times, dev, card, s4)
    tracked = os.path.join(ROOT, "native", "libcompv_native.so")
    tracked_sha = sha256_of(tracked)
    s5 = timed(19, phase19_slice5, dev, scene)
    timed(20, phase20_slice5_times, card, s5)
    check(sha256_of(tracked) == tracked_sha,
          "native/libcompv_native.so changed during slice 5")
    s6 = timed(21, phase21_distributed, dev, card, scene, sfm)
    s7 = timed(22, phase22_examples, dev, card)
    s8 = timed(23, phase23_bench, dev, card)
    timed(24, phase24_sweep, dev)
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
        "bound_by": bounds[kid]["bound_by"], "library_ms": None,
        **({"launches_per_run_sfm": sfm["sfm_32_480p"]["k1_launches"],
            "run_sfm_at": "sfm_long, 32 frames at 480x640",
            "launches_per_track_planar_sequence": s3["k1_per_track"],
            "track_planar_sequence_at": f"{PLANAR_FRAMES} frames at "
                                        "720x1282, 4 levels",
            "launches_per_recording": s5["rec"]["launches"]["K1"],
            "recording_at": f"{RECORDING_FRAMES} frames of 720x1282: "
                            f"{RECORDING_FRAMES - 1} match_pair at 8 levels "
                            "(16 a pair), ORB of each of those frames for "
                            "its drawing (8) and of the template once (8)",
            "launches_per_live_frame":
                s5["live"]["launches"]["K1"] / LIVE_FRAMES,
            "live_frame_at": "1280x720, OrbConfig(max_features=2000, "
                             f"levels=8), {LIVE_FRAMES} frames",
            "launches_per_sharded_orb_detect_by_rank":
                s6["k1_launches_by_rank"],
            "sharded_orb_detect_at": f"{DIST_FRAMES} frames of 720x1282 "
                                     f"on {DIST_RANKS} ranks of one card, "
                                     "OrbConfig(), 8 levels"}
           if kid == "K1" else {}),
        **({"launches_in_registry_mser": s5["registry"]["mser"].get(kid, 0),
            "registry_mser_at": "one mser_detect of the 720x1282 scene "
                                "through create_detector('mser')"}
           if kid in ("K2a", "K2b") else {}),
        **({"launches_per_calibration": s3["k4_per_calibration"],
            "calibration_at": "8 views at 720x1280"}
           if kid == "K4" else {}),
        **({"launches_per_example_program": {
            name: run["launches"][kid]
            for name, run in s7["in_process"].items()
            if kid in run["launches"]}} if kid in ("K1", "K4") else {}),
        **({"launches_per_bench_row": {
            name: row["launches"][kid] for name, row in s8["rows"].items()
            if kid in row["launches"]}} if kid != "K5" else {})}
        for kid, (name, source, replaces) in KERNELS.items()]})
    emit({"phase_s": PHASE_S,
          "total_s": round(time.perf_counter() - t_start, 3), "card": card})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
