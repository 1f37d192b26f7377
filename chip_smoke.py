"""Smoke test of the PyTorch / CUDA port (compv_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. device and build: the card's name and power limit, the kernels' build;
  2. kernel vs twin: the FAST kernel K1 against its plain PyTorch twin, by
     exact equality, on the 720p scene and its pyramid and on odd sizes;
  3. goldens on the card: goldens/goldens.json's FAST tuples, homography
     and md5 values, computed by the port on the GPU;
  4. the slice: slam.frontend.match_pair on a 720x1282 scene paired with
     its roll by (4, 7), at the full ORB/RANSAC configuration, with the
     kernel's launch count, geometric and determinism checks, and the same
     pair through the kernel's twins;
  5. times: match_pair and the two-output K1 launch against its twin, as
     medians of CUDA-event timings.

Any failed check raises, and the script exits non-zero; so it does without a
GPU, and outside a checkout of the repository. The last line of standard
output is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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
KERNEL_SOURCE = "compv_tpu_torch/csrc/fast_kernel.cu"
KERNEL_REPLACES = "compv_tpu/ops/pallas/fast_kernel.py:129"


class CheckFailed(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def scene_720p() -> np.ndarray:
    """The 720x1282 gray scene of bench.py's frontend_pair_720p row: gradient,
    checkerboard patch, sensor noise, from seed 0."""
    h, w = 720, 1282
    rs = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > 300) & (xx < 1000) & (yy > 150) & (yy < 570),
                    ch * 200.0 + 20, base)
    return np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)


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


def load_fixtures():
    """tests/fixtures.py of this checkout (numpy only), loaded by path: a
    package named ``tests`` elsewhere on sys.path would shadow it."""
    spec = importlib.util.spec_from_file_location(
        "compv_fixtures", os.path.join(ROOT, "tests", "fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase1_device_and_build():
    from compv_tpu_torch.device import require_cuda
    from compv_tpu_torch.ops.kernels import _build, fast_kernel

    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    emit(card)
    t0 = time.perf_counter()
    lib_path = _build.build("fast_kernel")
    fast_kernel._kernel_lib()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": 1, "device": torch.cuda.get_device_name(dev), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build_s, 3), "library": lib_path.name,
          "ptxas": ptxas})
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
    emit({"phase": 3, "goldens": "met", "checked": [
        "fast9_thr20_nms1", "fast9_thr20_nms0", "fast12_thr40_nms1",
        "fast9_thr40_nms1", "md5_to_gray", "md5_scale_bilinear_299x401",
        "homography_inliers", "homography_hash_q2"]})


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


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    dev, card = phase1_device_and_build()
    scene = scene_720p()
    err = phase2_kernel_vs_twin(dev, scene)
    phase3_goldens(dev)
    cfg, img1, img2, launches = phase4_slice(dev, scene)
    kernel_ms, twin_ms = phase5_times(dev, card, cfg, img1, img2)
    emit({"kernels": [{
        "name": "fast_strengths_nms", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": twin_ms}]})
    emit(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
