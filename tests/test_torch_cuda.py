"""The hand kernels on the card: FAST (K1), the CCL labeler (K2a / K2b),
the row compactor (K3), the SHT accumulator (K4) and the strip label
counter (K5), each against its plain twin, exact, and the port on CUDA
against the port on CPU (slice 3 too: calibration, the pose graph, planar
tracking's K1 launches, the Q0.16 blur, scaling and rotate_fast; slice 4:
HOG's determinism, the image ops, saturating arithmetic, SVM, PCA and
KNN; slice 5: the Timer's wait, the trace file of one K1 launch,
memory statistics, drawing from results on the card, frames uploaded from
recycled staging buffers; slice 6: ``sharded_detect`` on two ranks of the
card over gloo). Every test needs an NVIDIA GPU and nvcc, and skips
without them.

This file imports neither JAX nor ``compv_tpu``, so it runs on a machine
without them; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from compv_tpu_torch.features.fast import FastConfig, fast_detect
from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
from compv_tpu_torch.ops.kernels import fast_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _scene(h, w, seed=0):
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > w * 0.2) & (xx < w * 0.8) & (yy > h * 0.2)
                    & (yy < h * 0.8), ch * 200.0 + 20, base)
    return np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (8, 32), (33, 47),
                                   (299, 401), (720, 1282)])
@pytest.mark.parametrize("threshold,n", [(20, 9), (40, 12)])
def test_kernel_equals_twin(dev, shape, threshold, n):
    img = torch.from_numpy(_scene(*shape)).to(dev)
    raw = fast_kernel._strengths_ref(img, threshold, n)
    sup = fast_kernel._nms_ref(raw)
    for nms, want in ((False, raw), (True, sup)):
        got = fast_kernel.fast_strengths_nms(img, threshold, n, nms, as_f32=True)
        assert torch.equal(got, want)
        got = fast_kernel.fast_strengths_nms(img, threshold, n, nms)
        assert torch.equal(got, want.to(torch.uint8))
    got_raw, got_sup = fast_kernel.fast_strengths_and_nms(img, threshold, n)
    assert torch.equal(got_raw, raw) and torch.equal(got_sup, sup)
    torch.cuda.synchronize()


def _hard_images():
    rs = np.random.default_rng(2)
    yy, xx = np.mgrid[0:131, 0:259]
    out = {"noise": rs.integers(0, 256, (301, 517), dtype=np.uint8)}
    for period in (1, 3):
        out[f"checker_{period}"] = (((yy // period + xx // period) % 2)
                                    * 255).astype(np.uint8)
    # every residue of the width mod 4, around the kernel's 62-wide tile,
    # at heights below, at and above the 7 rows a strength needs
    for hh in (1, 7, 8, 9):
        for ww in (60, 61, 62, 63, 64, 65, 66, 67):
            out[f"{hh}x{ww}"] = rs.integers(0, 256, (hh, ww), dtype=np.uint8)
    return out


@pytest.mark.parametrize("threshold", [0, 20, 255])
@pytest.mark.parametrize("n", [9, 12])
def test_kernel_equals_twin_on_hard_images(dev, threshold, n):
    for name, im in _hard_images().items():
        img = torch.from_numpy(im).to(dev)
        raw = fast_kernel._strengths_ref(img, threshold, n)
        sup = fast_kernel._nms_ref(raw)
        got_raw, got_sup = fast_kernel.fast_strengths_and_nms(img, threshold,
                                                              n)
        assert torch.equal(got_raw, raw), name
        assert torch.equal(got_sup, sup), name
        assert torch.equal(fast_kernel.fast_strengths_nms(img, threshold, n),
                           sup.to(torch.uint8)), name
    torch.cuda.synchronize()


def test_kernel_takes_a_misaligned_base(dev):
    rs = np.random.default_rng(3)
    flat = torch.from_numpy(rs.integers(0, 256, (3 + 100 * 77,),
                                        dtype=np.uint8)).to(dev)
    for off in (1, 2, 3):
        img = flat[off:off + 100 * 77].view(100, 77)
        raw = fast_kernel._strengths_ref(img, 20, 9)
        got_raw, got_sup = fast_kernel.fast_strengths_and_nms(img, 20, 9)
        assert torch.equal(got_raw, raw), off
        assert torch.equal(got_sup, fast_kernel._nms_ref(raw)), off


def test_early_out_counts_equal_the_model(dev):
    """What the kernel's early-out did, counted by the kernel, against the
    model of its geometry; flat regions are skipped, noise is not."""
    images = {"scene": _scene(240, 320), "scene_720p": _scene(720, 1282),
              **_hard_images()}
    for name, im in images.items():
        img = torch.from_numpy(im).to(dev)
        got = fast_kernel.early_out_counts(img, 20, 9)
        want = fast_kernel._early_out_counts_ref(img, 20)
        assert torch.equal(got, want), name
    flat = torch.full((240, 320), 90, dtype=torch.uint8, device=dev)
    tested, skipped, _, _ = fast_kernel.early_out_counts(flat).tolist()
    assert tested > 0 and skipped == tested
    noise = torch.from_numpy(images["noise"]).to(dev)
    tested, skipped, _, _ = fast_kernel.early_out_counts(noise).tolist()
    assert skipped < 0.05 * tested


def test_kernel_counts_its_launches(dev):
    img = torch.zeros((16, 16), dtype=torch.uint8, device=dev)
    before = fast_kernel.launches
    fast_kernel.fast_strengths_nms(img)
    fast_kernel.fast_strengths_and_nms(img)
    assert fast_kernel.launches == before + 2


def test_kernel_rejects_non_contiguous(dev):
    img = torch.zeros((16, 32), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        fast_kernel.fast_strengths_nms(img)


def test_fast_detect_cuda_equals_cpu(dev):
    img = _scene(240, 320, seed=4)
    cfg = FastConfig(max_features=4096)
    a = fast_detect(torch.from_numpy(img), cfg)
    b = fast_detect(torch.from_numpy(img).to(dev), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())


def test_orb_cuda_matches_cpu(dev):
    """Detector outputs exact; orientation and BRIEF within the cross-device
    ulp tolerances (atan2 / cos / sin of another math library)."""
    img = _scene(240, 320, seed=5)
    cfg = OrbConfig(max_features=500, levels=4)
    a = orb_detect_describe(torch.from_numpy(img), cfg)
    b = orb_detect_describe(torch.from_numpy(img).to(dev), cfg)
    for name in ("x", "y", "strength", "level", "size", "valid"):
        assert torch.equal(getattr(a.keypoints, name),
                           getattr(b.keypoints, name).cpu()), name
    d = (a.keypoints.orientation - b.keypoints.orientation.cpu()).abs()
    assert float(torch.minimum(d, 360 - d).max()) <= 1e-3
    assert float((a.descriptors != b.descriptors.cpu()).float().mean()) <= 1e-3


# ---------------------------------------------------------------------------
# CCL labeler (K2a / K2b) and row compactor (K3) against their twins

from compv_tpu_torch.features.ccl import (CclConfig, ccl_features,  # noqa: E402
                                          extract_runs)
from compv_tpu_torch.features.mser import MserConfig, mser_detect  # noqa: E402
from compv_tpu_torch.ops.kernels import ccl_kernel, compact_kernel  # noqa: E402


def _snake(h=40, w=40):
    img = np.zeros((h, w), np.uint8)
    for r in range(0, h, 4):
        img[r, :] = 1
        if r + 4 < h:
            img[r:r + 4, w - 1 if (r // 4) % 2 == 0 else 0] = 1
    return img


def _binaries():
    rs = np.random.default_rng(3)
    out = [(rs.random((64, 80)) < d).astype(np.uint8) for d in (0.3, 0.5, 0.6)]
    out += [(rs.random((300, 517)) < 0.5).astype(np.uint8), _snake(),
            _snake(64, 200), np.zeros((17, 33), np.uint8),
            np.ones((17, 33), np.uint8), np.ones((1, 1), np.uint8),
            np.zeros((1, 1), np.uint8), (rs.random((1, 77)) < 0.5)
            .astype(np.uint8), (rs.random((77, 1)) < 0.5).astype(np.uint8),
            np.ones((1, 77), np.uint8), np.ones((77, 1), np.uint8)]
    return out


@pytest.mark.parametrize("connectivity", [4, 8])
def test_ccl_kernel_equals_twin(dev, connectivity):
    for img in _binaries():
        t = torch.from_numpy(img * 255)
        # rounds enough for the twin on near-percolation inputs
        want = ccl_kernel.label_ref(t != 0, torch.arange(
            img.size, dtype=torch.int32).reshape(img.shape), connectivity,
            1000)
        got = ccl_kernel.ccl_label(t.to(dev), connectivity)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), img.shape


def _serpent(h, w, step):
    """One component that winds through the whole map."""
    img = np.zeros((h, w), np.uint8)
    for k, r in enumerate(range(0, h, step)):
        img[r, :] = 1
        if r + step < h:
            img[r:r + step, w - 1 if k % 2 == 0 else 0] = 1
    return img


def _scipy_labels(img, connectivity):
    """Min-flat-index labels from scipy.ndimage.label's partition."""
    from scipy import ndimage

    structure = np.ones((3, 3)) if connectivity == 8 else None
    lab, n = ndimage.label(img > 0, structure=structure)
    out = np.full(img.shape, -1, np.int32)
    if n:
        flat = np.arange(img.size).reshape(img.shape)
        mins = np.asarray(ndimage.minimum(flat, lab, np.arange(1, n + 1)))
        out[lab > 0] = mins.astype(np.int32)[lab[lab > 0] - 1]
    return out


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", ["tile_edges", "serpents", "full",
                                  "checkerboards", "thin", "large"])
def test_ccl_kernel_on_tile_edge_cases(dev, connectivity, case):
    """What stresses the labeler's 32 x 32 tiling, against scipy's
    partition, twice: sizes one below, at and above a multiple of the tile
    each way, a component through every tile, a full map, checkerboards of
    single pixels, maps one pixel thin, a 2160 x 3840 random map."""
    rs = np.random.default_rng(21)
    yy, xx = np.mgrid[0:131, 0:197]
    images = {
        "tile_edges": [(rs.random((hh, ww)) < 0.55).astype(np.uint8)
                       for hh in (31, 32, 33, 63, 64, 65)
                       for ww in (31, 32, 33, 63, 64, 65)],
        "serpents": [_serpent(200, 301, 2), _serpent(97, 130, 3),
                     _serpent(64, 64, 4).T.copy()],
        "full": [np.ones((65, 97), np.uint8), np.ones((1182, 1122), np.uint8)],
        "checkerboards": [((yy + xx) % 2).astype(np.uint8),
                          ((yy + xx + 1) % 2).astype(np.uint8),
                          ((yy + xx) % 3 == 0).astype(np.uint8),
                          ((yy - xx) % 3 == 0).astype(np.uint8)],
        "thin": [np.ones((1, 1), np.uint8), np.ones((1, 130), np.uint8),
                 np.ones((130, 1), np.uint8),
                 (rs.random((1, 1122)) < 0.5).astype(np.uint8),
                 (rs.random((1182, 1)) < 0.5).astype(np.uint8)],
        "large": [(rs.random((2160, 3840)) < 0.5).astype(np.uint8)],
    }[case]
    for img in images:
        t = torch.from_numpy(img).to(dev)
        got = ccl_kernel.ccl_label(t, connectivity)
        again = ccl_kernel.ccl_label(t, connectivity)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(),
                              _scipy_labels(img, connectivity)), img.shape
        assert torch.equal(got, again), img.shape


@pytest.mark.parametrize("connectivity", [4, 8])
def test_ccl_seeded_kernel_equals_twin(dev, connectivity):
    """A nested ladder of level sets, each level seeded by the previous
    one's labels, as MSER runs it."""
    img = _scene(96, 128, seed=6)
    prev = torch.full(img.shape, -1, dtype=torch.int32)
    idx = torch.arange(img.size, dtype=torch.int32).reshape(img.shape)
    for t in range(20, 256, 20):
        fg = torch.from_numpy(img <= t)
        init = torch.where(prev >= 0, prev, idx)
        want = ccl_kernel.label_ref(fg, init, connectivity)
        got = ccl_kernel.ccl_label_seeded(fg.to(dev), init.to(dev),
                                          connectivity)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), t
        prev = want


@pytest.mark.parametrize("connectivity", [4, 8])
def test_ccl_seeded_kernel_is_warm_started_k2a(dev, connectivity):
    """On every level of a nested ladder the seeded kernel gives the
    unseeded kernel's labels, from the ladder's seed and from an own-index
    seed alike, and the same labels when it runs again."""
    rs = np.random.default_rng(14)
    for img in (_scene(96, 128, seed=6),
                rs.integers(0, 256, (300, 517), dtype=np.uint8)):
        prev = torch.full(img.shape, -1, dtype=torch.int32, device=dev)
        idx = torch.arange(img.size, dtype=torch.int32,
                           device=dev).reshape(img.shape)
        for t in range(20, 256, 20):
            fg = torch.from_numpy(img <= t).to(dev)
            init = torch.where(prev >= 0, prev, idx)
            want = ccl_kernel.ccl_label(fg, connectivity)
            got = ccl_kernel.ccl_label_seeded(fg, init, connectivity)
            again = ccl_kernel.ccl_label_seeded(fg, init, connectivity)
            cold = ccl_kernel.ccl_label_seeded(fg, idx, connectivity)
            torch.cuda.synchronize()
            assert torch.equal(got, want), t
            assert torch.equal(again, got), t
            assert torch.equal(cold, want), t
            prev = got


@pytest.mark.parametrize("connectivity", [4, 8])
def test_ccl_seeded_kernel_sanitises_bad_seeds(dev, connectivity):
    """Seeds below 0, past the pixel's own index or on a background pixel
    count as the own index: in bounds, and the labels of the mask."""
    rs = np.random.default_rng(15)
    fg = rs.random((120, 333)) < 0.5
    n = fg.size
    want = ccl_kernel.label_ref(torch.from_numpy(fg), torch.arange(
        n, dtype=torch.int32).reshape(fg.shape), connectivity, 1000)
    init = torch.where(want >= 0, want, 0).reshape(-1).numpy().copy()
    on = np.flatnonzero(fg.reshape(-1))
    off = np.flatnonzero(~fg.reshape(-1))
    hit = rs.choice(on[on > off[0]], 4000, replace=False)
    init[hit[:1000]] = -1
    init[hit[1000:2000]] = 2 ** 31 - 1
    init[hit[2000:3000]] = np.minimum(hit[2000:3000] + 1, n - 1)
    init[hit[3000:]] = off[np.searchsorted(off, hit[3000:]) - 1]
    init[off] = rs.integers(-2 ** 31, 2 ** 31 - 1, off.size)   # never read
    got = ccl_kernel.ccl_label_seeded(
        torch.from_numpy(fg).to(dev),
        torch.from_numpy(init.reshape(fg.shape)).to(dev), connectivity)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("h,k,cap8,case", [
    (1, 8, 4, "one row"), (7, 16, 64, "below a block of rows"),
    (9, 16, 64, "one past a block of rows"), (1182, 128, 8192, "sparse"),
    (9, 16, 64, "zero counts"), (9, 16, 64, "counts above K"),
    (40, 24, 30, "overflow"), (1182, 128, 8192, "overflow"),
    (9, 16, 2, "capacity of one row")])
def test_compact_kernel_edge_cases(dev, h, k, cap8, case):
    rs = np.random.default_rng(h * 131 + k)
    if case == "zero counts":
        counts = np.zeros(h, np.int32)
    elif case == "counts above K":
        counts = rs.integers(k, 3 * k, h).astype(np.int32)
    else:
        top = k // 2 if case == "sparse" else k + 9
        counts = rs.integers(0, top, h).astype(np.int32)
        counts[rs.random(h) < 0.2] = 0
    a = torch.from_numpy(rs.integers(-2 ** 31, 2 ** 31, (h, k),
                                     dtype=np.int64).astype(np.int32))
    b = torch.from_numpy(rs.integers(0, 10 ** 6, (h, k)).astype(np.int32))
    counts = torch.from_numpy(counts)
    want = compact_kernel.compact_ref(a, b, counts, cap8)
    got = compact_kernel.compact_rows(a.to(dev), b.to(dev), counts.to(dev),
                                      cap8)
    torch.cuda.synchronize()
    total, ok = int(want[2]), bool(want[3])
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    assert int(got[2]) == total and bool(got[3]) == ok
    assert int(got[3].view(torch.uint8)) in (0, 1)
    defined = total if ok else max(cap8 - k // 8, 0) * 8
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g[:defined].cpu(), w[:defined])


def test_compact_rows_is_one_device_operation(dev):
    from torch.profiler import ProfilerActivity, profile

    counts = torch.full((1182,), 5, dtype=torch.int32, device=dev)
    table = torch.zeros((1182, 128), dtype=torch.int32, device=dev)
    compact_kernel.compact_rows(table, table, counts, 8192)
    torch.cuda.synchronize()
    ops = []
    for _ in range(3):      # a window can come back without device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            compact_kernel.compact_rows(table, table, counts, 8192)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    if not ops:
        pytest.skip("torch.profiler recorded no device event in 3 windows")
    assert len(ops) == 1, ops


def test_compact_kernel_equals_twin(dev):
    rs = np.random.default_rng(8)
    lbl = ccl_kernel.label_ref(torch.from_numpy(rs.random((120, 300)) < 0.4),
                               torch.arange(36000, dtype=torch.int32)
                               .reshape(120, 300), 8, 1000)
    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, 64)
    assert int(counts.max()) > 64            # rows past the record width
    a, b = run_lbl.contiguous(), (run_x0 * 1000 + run_x1).contiguous()
    for cap8 in (4096, 300):                 # fits; overflows
        want = compact_kernel.compact_ref(a, b, counts, cap8)
        got = compact_kernel.compact_rows(a.to(dev), b.to(dev),
                                          counts.to(dev), cap8)
        torch.cuda.synchronize()
        total, ok = int(want[2]), bool(want[3])
        assert int(got[2]) == total and bool(got[3]) == ok
        assert ok == (cap8 == 4096)
        defined = total if ok else (cap8 - 64 // 8) * 8
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(g[:defined].cpu(), w[:defined])


def test_new_kernels_count_their_launches(dev):
    fg = torch.ones((8, 8), dtype=torch.uint8, device=dev)
    init = torch.arange(64, dtype=torch.int32, device=dev).reshape(8, 8)
    counts = torch.full((8,), 3, dtype=torch.int32, device=dev)
    table = torch.zeros((8, 8), dtype=torch.int32, device=dev)
    before = (ccl_kernel.ccl_label.launches,
              ccl_kernel.ccl_label_seeded.launches,
              compact_kernel.compact_rows.launches)
    ccl_kernel.ccl_label(fg)
    ccl_kernel.ccl_label_seeded(fg, init)
    compact_kernel.compact_rows(table, table, counts, 16)
    assert (ccl_kernel.ccl_label.launches,
            ccl_kernel.ccl_label_seeded.launches,
            compact_kernel.compact_rows.launches) == tuple(
                x + 1 for x in before)


def test_ccl_features_cuda_equals_cpu(dev):
    img = (_scene(150, 200, seed=9) < 110).astype(np.uint8)
    cfg = CclConfig(max_components=1024)
    a = ccl_features(torch.from_numpy(img), cfg)
    b = ccl_features(torch.from_numpy(img).to(dev), cfg)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y.cpu()), name


def test_mser_cuda_equals_cpu(dev):
    img = _scene(96, 128, seed=10)
    for dark in (True, False):
        cfg = MserConfig(dark=dark, max_regions=32)
        a = mser_detect(torch.from_numpy(img), cfg)
        b = mser_detect(torch.from_numpy(img).to(dev), cfg)
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y.cpu()), name


# ---------------------------------------------------------------------------
# SHT accumulator (K4), strip label counter (K5) and the Hough path

from compv_tpu_torch.calib.checkerboard import (  # noqa: E402
    CheckerboardConfig, find_chessboard_corners)
from compv_tpu_torch.features.canny import CannyConfig, canny  # noqa: E402
from compv_tpu_torch.features.ccl import label_components  # noqa: E402
from compv_tpu_torch.features.edges import sobel_gradients  # noqa: E402
from compv_tpu_torch.features.hough import (  # noqa: E402
    HoughKhtConfig, HoughShtConfig, hough_kht, hough_sht)
from compv_tpu_torch.features.hough_trig import (  # noqa: E402
    theta_count, theta_table)
from compv_tpu_torch.ops.kernels import hough_kernel, label_stats  # noqa: E402


def _edge_list(seed, n, h, w, valid_frac=0.7):
    rs = np.random.default_rng(seed)
    return (torch.from_numpy(rs.integers(0, w, n).astype(np.float32)),
            torch.from_numpy(rs.integers(0, h, n).astype(np.float32)),
            torch.from_numpy((rs.random(n) < valid_frac).astype(np.int32)))


def _sht(x, y, wt, step, rho_max, rho_step, fn):
    cos_t, sin_t = theta_table(step, x.device)
    return fn(x, y, wt, theta_count(step), rho_max, rho_step, cos_t, sin_t)


@pytest.mark.parametrize("step", [1.0, 0.5])
@pytest.mark.parametrize("rho_step", [1.0, 0.7])
@pytest.mark.parametrize("n,h,w", [(0, 8, 8), (3, 5, 7), (4000, 240, 320),
                                   (65536, 720, 1282), (65536, 2160, 3840)])
def test_sht_kernel_equals_twin(dev, step, rho_step, n, h, w):
    x, y, wt = (t.to(dev) for t in _edge_list(n, n, h, w))
    rho_max = float(np.hypot(h, w))
    want = _sht(x, y, wt, step, rho_max, rho_step,
                hough_kernel.sht_accumulate_ref)
    got = _sht(x, y, wt, step, rho_max, rho_step,
               hough_kernel.sht_accumulate)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert int(got.sum()) == theta_count(step) * int(wt.sum())


@pytest.mark.parametrize("case", ["E_1", "E_3", "E_2047", "E_2049",
                                  "E_4097", "E_70001", "scattered_heavy",
                                  "off_16_bytes", "theta_1", "theta_181"])
def test_sht_kernel_ragged_cases(dev, case):
    """The shapes of the kernel's split: lists that end inside a group of
    128 slots or a warp's four groups, edges scattered over the list with
    weights above 1, arrays off 16 bytes, 1 and 181 thetas."""
    rs = np.random.default_rng(17)
    n = int(case[2:]) if case.startswith("E_") else 65536
    h, w = 720, 1282
    x = torch.from_numpy(rs.integers(0, w, n).astype(np.float32)).to(dev)
    y = torch.from_numpy(rs.integers(0, h, n).astype(np.float32)).to(dev)
    wt = np.zeros(n, np.int32)
    wt[:max(1, int(0.4 * n))] = 1
    if case == "scattered_heavy":
        wt = ((rs.random(n) < 0.4) * rs.integers(1, 5, n)).astype(np.int32)
    wt = torch.from_numpy(wt).to(dev)
    if case == "off_16_bytes":
        x, y, wt = x[1:], y[1:], wt[1:]
    cos_t, sin_t = theta_table(1.0, dev)
    n_theta = 180
    if case == "theta_1":
        n_theta, cos_t, sin_t = 1, cos_t[:1].contiguous(), sin_t[:1].contiguous()
    if case == "theta_181":
        n_theta = 181
        cos_t, sin_t = torch.cat([cos_t, cos_t[:1]]), torch.cat([sin_t,
                                                                 sin_t[:1]])
    args = (x, y, wt, n_theta, float(np.hypot(h, w)), 1.0, cos_t, sin_t)
    got = hough_kernel.sht_accumulate(*args)
    want = hough_kernel.sht_accumulate_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got.sum()) == n_theta * int(wt.sum())


@pytest.mark.parametrize("n_theta,n_rho", [(180, 2942), (360, 2942),
                                           (180, 8813), (1, 2942),
                                           (181, 4202), (180, 58112),
                                           (180, 58746), (180, 88118),
                                           (1, 88118), (360, 1000003)])
def test_sht_plan_fits_the_card(dev, n_theta, n_rho):
    t, s, tiles = hough_kernel.sht_plan(n_theta, n_rho, dev)
    optin = hough_kernel._kernel_lib().compv_sht_smem_optin(0)
    assert t >= 1 and s in (1, 2, 4, 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if n_rho * 4 <= optin:
        assert tiles == 1 and t * n_rho * 4 <= optin
        # one wave, one CTA an SM, unless shared memory holds no more thetas
        assert (-(-n_theta // t) * s <= sms
                or t == min(optin // (n_rho * 4), 16))
    else:                   # rho tiles of a power of two of bins
        width = -(-n_rho // tiles)
        tile = 1 << (width - 1).bit_length()
        assert tiles > 1 and t * tile * 4 <= optin < 2 * tile * 4
        assert (tiles - 1) * tile < n_rho <= tiles * tile
        assert s == 1 or n_theta * tiles < sms


def test_sht_plan_at_the_paths_shapes(dev):
    """The plans of the Hough path's shapes on an H100 (132 SMs)."""
    if torch.cuda.get_device_properties(dev).multi_processor_count != 132:
        pytest.skip("the plans are those of 132 SMs")
    assert hough_kernel.sht_plan(180, 2942, dev) == (6, 4, 1)
    assert hough_kernel.sht_plan(180, 8813, dev) == (6, 4, 1)
    assert hough_kernel.sht_plan(180, 88118, dev) == (1, 1, 3)


def test_sht_accumulate_is_one_device_operation(dev):
    from torch.profiler import ProfilerActivity, profile

    x, y, wt = (t.to(dev) for t in _edge_list(4, 65536, 720, 1282))
    cos_t, sin_t = theta_table(1.0, dev)

    def call():
        return hough_kernel.sht_accumulate(
            x, y, wt, 180, float(np.hypot(720, 1282)), 1.0, cos_t, sin_t)

    call()
    torch.cuda.synchronize()
    ops = []
    for _ in range(3):      # a window can come back without device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    if not ops:
        pytest.skip("torch.profiler recorded no device event in 3 windows")
    assert len(ops) == 1, ops


@pytest.mark.parametrize("n,rho_max,rho_step,step", [
    (16, 40000.0, 1.0, 1.0),               # 80,001 bins, nearly all empty
    (65536, float(np.hypot(2160, 3840)), 0.1, 1.0),    # 88,118 bins
    (65536, float(np.hypot(2160, 3840)), 0.15, 1.0),   # 58,746: two tiles
    (70001, float(np.hypot(2160, 3840)), 0.1, 0.5),
    (5000, float(np.hypot(720, 1282)), 0.02, 1.0)])    # 147,036 bins
def test_sht_kernel_equals_twin_past_shared_memory(dev, n, rho_max, rho_step,
                                                   step):
    """A theta row wider than a block's shared memory: the kernel tiles
    rho and still equals the twin, no vote lost."""
    x, y, wt = (t.to(dev) for t in _edge_list(n, n, 2160, 3840))
    if n == 70001:
        wt = wt * 3
    want = _sht(x, y, wt, step, rho_max, rho_step,
                hough_kernel.sht_accumulate_ref)
    got = _sht(x, y, wt, step, rho_max, rho_step,
               hough_kernel.sht_accumulate)
    torch.cuda.synchronize()
    assert got.shape[1] * 4 > hough_kernel._kernel_lib(
        ).compv_sht_smem_optin(0)
    assert torch.equal(got, want)
    assert int(got.sum()) == theta_count(step) * int(wt.sum())


def test_hough_sht_wide_cuda_equals_cpu(dev):
    """hough_sht at a rho step of 0.1 on a 2160 x 3840 map (88,118 bins a
    theta): the card's lines are the CPU's."""
    rs = np.random.default_rng(19)
    img = ((rs.random((2160, 3840)) < 0.004) * 255).astype(np.uint8)
    img[1000, 200:3600] = 255
    img[300:1900, 2222] = 255
    cfg = HoughShtConfig(rho=0.1, threshold=0.5, max_lines=16)
    a = hough_sht(torch.from_numpy(img), cfg)
    b = hough_sht(torch.from_numpy(img).to(dev), cfg)
    assert int(a.count()) > 0
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y.cpu()), name


def _label_maps():
    rs = np.random.default_rng(12)
    maps = [label_components(torch.from_numpy(
        (rs.random(shape) < d).astype(np.uint8)), conn, 1000)
        for shape, d, conn in (((16, 96), 0.4, 4), ((21, 40), 0.5, 8),
                               ((300, 1122), 0.45, 8), ((13, 7), 0.6, 8))]
    maps.append(torch.full((10, 12), -1, dtype=torch.int32))
    return maps


@pytest.mark.parametrize("rounds,strip_rows", [(32, 8), (256, 8), (256, 4),
                                               (640, 8)])
def test_strip_counts_kernel_equals_twin(dev, rounds, strip_rows):
    for lbl in _label_maps():
        want = label_stats.strip_label_counts_ref(lbl, rounds, strip_rows)
        got = label_stats.strip_label_counts(lbl.to(dev), rounds, strip_rows)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), tuple(lbl.shape)


@pytest.mark.parametrize("case", ["8x8192", "16x4096", "per_pixel",
                                  "per_pixel_descending", "rounds_11000",
                                  "random_labels", "one_long_run"])
def test_strip_counts_kernel_past_the_first_kernels_limits(dev, case):
    """Strips of 65,536 labels (twice what the first kernel's shared memory
    held), maps where every pixel is its own run, a list of 11,000 labels,
    labels up to 2^31 - 1 in no order, one run over a whole strip."""
    rs = np.random.default_rng(22)
    rounds, strip_rows = 256, 8
    if case in ("8x8192", "16x4096"):
        lbl = label_components(torch.from_numpy(
            (rs.random((40, 8192)) < 0.45).astype(np.uint8)), 8, 1000)
        if case == "16x4096":
            lbl, strip_rows = lbl[:, :4096].contiguous(), 16
    elif case.startswith("per_pixel"):
        lbl = torch.arange(64 * 1122, dtype=torch.int32).reshape(64, 1122)
        if case.endswith("descending"):
            lbl = lbl.flip(1).contiguous()
    elif case == "rounds_11000":
        lbl = torch.arange(16 * 1122, dtype=torch.int32).reshape(16, 1122)
        rounds = 11000
    elif case == "random_labels":
        lbl = torch.from_numpy(rs.integers(
            -3, 2 ** 31 - 1, (64, 2777), dtype=np.int64).astype(np.int32))
        rounds, strip_rows = 700, 16
    else:
        lbl = torch.full((16, 5000), 7, dtype=torch.int32)
    want = label_stats.strip_label_counts_ref(lbl, rounds, strip_rows)
    got = label_stats.strip_label_counts(lbl.to(dev), rounds, strip_rows)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_strip_counts_kernel_states_its_rounds_limit(dev):
    """A list past a block's shared memory no longer raises: the kernel
    keeps it in device memory, and the result is the twin's."""
    lbl = torch.zeros((8, 8192), dtype=torch.int32, device=dev)
    got = label_stats.strip_label_counts(lbl, 40000, 8)
    assert got[1].tolist() == [1] and got[0][0, :, 0].tolist() == [0, 65536]
    small = torch.zeros((8, 16), dtype=torch.int32, device=dev)
    got = label_stats.strip_label_counts(small, 40000, 8)    # 128 pixels
    assert got[1].tolist() == [1] and got[0][0, :, 0].tolist() == [0, 128]


@pytest.mark.parametrize("rounds", [11520, 65536])
@pytest.mark.parametrize("case", ["per_pixel", "random_binary"])
def test_strip_counts_kernel_past_shared_memory(dev, rounds, case):
    """min(rounds, strip pixels) above 11,519: the list in device memory,
    exact against the twin (per-pixel labels fill it; a random binary's
    components truncate at neither size)."""
    rs = np.random.default_rng(31)
    if case == "per_pixel":
        lbl = torch.arange(24 * 8192, dtype=torch.int32).reshape(24, 8192)
        lbl = lbl.flip(1).contiguous()
    else:
        lbl = label_components(torch.from_numpy(
            (rs.random((40, 8192)) < 0.45).astype(np.uint8)), 8, 1000)
    want = label_stats.strip_label_counts_ref(lbl, rounds, 8)
    before = label_stats.strip_label_counts.launches
    got = label_stats.strip_label_counts(lbl.to(dev), rounds, 8)
    torch.cuda.synchronize()
    assert label_stats.strip_label_counts.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_hough_kernels_count_their_launches(dev):
    x, y, wt = (t.to(dev) for t in _edge_list(1, 64, 20, 30))
    lbl = torch.zeros((16, 16), dtype=torch.int32, device=dev)
    before = (hough_kernel.sht_accumulate.launches,
              label_stats.strip_label_counts.launches)
    _sht(x, y, wt, 1.0, 40.0, 1.0, hough_kernel.sht_accumulate)
    label_stats.strip_label_counts(lbl)
    assert (hough_kernel.sht_accumulate.launches,
            label_stats.strip_label_counts.launches) == tuple(
                b + 1 for b in before)


def _board(rows=6, cols=8, square=40, margin=60, angle_deg=0.0):
    """A rendered chessboard (tests/test_checkerboard.py:render_board)."""
    h = (rows + 1) * square + 2 * margin
    w = (cols + 1) * square + 2 * margin
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    th = np.deg2rad(angle_deg)
    xr = (xx - w / 2) * np.cos(th) + (yy - h / 2) * np.sin(th) + w / 2
    yr = -(xx - w / 2) * np.sin(th) + (yy - h / 2) * np.cos(th) + h / 2
    ix = np.floor((xr - margin) / square).astype(int)
    iy = np.floor((yr - margin) / square).astype(int)
    board = (((ix + iy) % 2 == 0) & (ix >= 0) & (ix <= cols) & (iy >= 0)
             & (iy <= rows))
    return np.where(board, 230, 30).astype(np.uint8)


def test_canny_and_hough_cuda_equal_cpu(dev):
    img = _scene(240, 320, seed=11)
    for cfg in (CannyConfig(), CannyConfig(20, 60)):
        a = canny(torch.from_numpy(img), cfg)
        b = canny(torch.from_numpy(img).to(dev), cfg)
        assert torch.equal(a, b.cpu())
    for cfg in (HoughShtConfig(threshold=30), HoughShtConfig(
            threshold=0.3, rho=0.7, theta_step_deg=0.5, max_lines=16)):
        la = hough_sht(a, cfg)
        lb = hough_sht(a.to(dev), cfg)
        for name, x, y in zip(la._fields, la, lb):
            assert torch.equal(x, y.cpu()), name
    gx, gy = sobel_gradients(torch.from_numpy(img))
    ka = hough_kht(a, gx, gy, HoughKhtConfig(min_votes=10.0))
    kb = hough_kht(a.to(dev), gx.to(dev), gy.to(dev),
                   HoughKhtConfig(min_votes=10.0))
    # atan2 of another math library may move a point's centre bin
    assert abs(int(ka.count()) - int(kb.count())) <= 1
    assert float((ka.strength.sum() - kb.strength.cpu().sum()).abs()) <= 4.0


@pytest.mark.parametrize("angle", [0.0, 12.0])
def test_chessboard_cuda_matches_cpu(dev, angle):
    img = _board(angle_deg=angle)
    a = find_chessboard_corners(torch.from_numpy(img), CheckerboardConfig())
    b = find_chessboard_corners(torch.from_numpy(img).to(dev),
                                CheckerboardConfig())
    assert bool(a.valid) and bool(b.valid)
    assert float((a.corners - b.corners.cpu()).abs().max()) <= 1e-3


# ---------------------------------------------------------------- SfM slice

from compv_tpu_torch.interop import ba_problem_from_numpy  # noqa: E402
from compv_tpu_torch.slam import ba as slam_ba  # noqa: E402
from compv_tpu_torch.slam import ba_schur as slam_schur  # noqa: E402
from compv_tpu_torch.slam import sfm as slam_sfm  # noqa: E402


def _ba_arrays(f=12, l=600, o=4000, seed=5):
    rs = np.random.default_rng(seed)
    cams = np.concatenate([rs.normal(0, 0.05, (f, 3)),
                           rs.normal(0, 0.4, (f, 3))], 1).astype(np.float32)
    lms = (rs.uniform(-2, 2, (l, 3)) + [0, 0, 7.0]).astype(np.float32)
    ci = rs.integers(0, f, o).astype(np.int32)
    li = rs.integers(0, l, o).astype(np.int32)
    prob = ba_problem_from_numpy({
        "cameras": cams, "landmarks": lms,
        "intrinsics": np.array([400.0, 400.0, 320.0, 240.0], np.float32),
        "cam_idx": ci, "lm_idx": li, "uv": np.zeros((o, 2), np.float32),
        "valid": np.ones(o, bool)})
    uv = slam_ba.project_points(prob.cameras, prob.landmarks,
                                prob.intrinsics, prob.cam_idx, prob.lm_idx)
    uv = uv + torch.from_numpy(rs.normal(0, 0.5, (o, 2)).astype(np.float32))
    cams_n = cams + rs.normal(0, 0.005, cams.shape).astype(np.float32)
    cams_n[:2] = cams[:2]
    return prob._replace(cameras=torch.from_numpy(cams_n), uv=uv)


@pytest.mark.parametrize("solver", ["cg", "schur"])
def test_ba_solve_on_the_card_is_deterministic_and_matches_cpu(dev, solver):
    """Two card runs bit-identical (no atomics in the sums); cost within
    1e-3 relative of the CPU run, cameras within 1e-3 (two pinned)."""
    prob = _ba_arrays()
    mask = torch.arange(12) >= 2

    def solve(p, m):
        if solver == "schur":
            return slam_schur.ba_solve_schur(
                p, slam_schur.SchurConfig(iterations=5, robust_delta=3.0), m)
        return slam_ba.ba_solve(p, slam_ba.BAConfig(
            iterations=6, cg_iterations=25, robust_delta=3.0), m)

    on_card = prob._replace(**{k: v.to(dev) for k, v in
                               prob._asdict().items()})
    a, ca = solve(on_card, mask.to(dev))
    b, cb = solve(on_card, mask.to(dev))
    h, ch = solve(prob, mask)
    torch.cuda.synchronize()
    assert torch.equal(a.cameras, b.cameras) and torch.equal(ca, cb)
    assert abs(float(ca) - float(ch)) <= 1e-3 * float(ch)
    assert float((a.cameras.cpu() - h.cameras).abs().max()) <= 1e-3


def test_sfm_6_frames_on_the_card_matches_cpu(dev):
    """render + run_sfm at 6 frames 120x160: frames and tracks equal to the
    CPU run, ATE within max(1.5x the CPU's, 3% of the span), K1 launched
    4 levels x 6 frames."""
    frames, gt, k = slam_sfm.render_orbit_sequence(6, 120, 160, device=dev)
    cpu_frames = slam_sfm.render_orbit_sequence(6, 120, 160, device="cpu")[0]
    assert np.array_equal(frames, cpu_frames)
    cfg = slam_sfm.SfmConfig(max_obs=4096, max_landmarks=1024)
    before = fast_kernel.launches
    ate, res = slam_sfm.sfm_ate(frames, gt, k, cfg, device=dev)
    torch.cuda.synchronize()
    assert fast_kernel.launches - before == 24
    ate_cpu, res_cpu = slam_sfm.sfm_ate(frames, gt, k, cfg, device="cpu")
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    assert res.num_tracks == res_cpu.num_tracks
    assert ate <= max(1.5 * ate_cpu, 0.03 * span)


# ---------------------------------------------------------------- slice 3

def test_calibrate_camera_cuda_matches_cpu(dev):
    """The same corners calibrated on the card and on the CPU: K and the
    RMS within 1e-3 relative; the RMS does not rise after LM."""
    from compv_tpu_torch.calib.camera import (calibrate_camera,
                                              checkerboard_object_points)
    from compv_tpu_torch.calib.utils import project_points_dist

    rs = np.random.default_rng(0)
    obj = checkerboard_object_points(6, 8, 30.0, device="cpu")
    k = torch.tensor([[800.0, 0, 320], [0, 810, 240], [0, 0, 1]])
    dist = torch.tensor([-0.2, 0.05, 0.0, 0.0])
    views = []
    for i in range(5):
        rvec = torch.tensor(np.array([0.12, -0.1, 0.05]) * (i - 2)
                            + rs.normal(0, 0.03, 3), dtype=torch.float32)
        tvec = torch.tensor([-120.0, -90.0, 900.0]) + torch.from_numpy(
            rs.normal(0, 12.0, 3).astype(np.float32))
        p = project_points_dist(obj, k, dist, rvec, tvec)
        views.append(p + torch.from_numpy(
            rs.normal(0, 0.1, p.shape).astype(np.float32)))
    img_pts = torch.stack(views)
    card = calibrate_camera(obj.to(dev), img_pts.to(dev))
    cpu = calibrate_camera(obj, img_pts)
    torch.cuda.synchronize()
    assert float((card.k.cpu() - cpu.k).abs().max()) <= 1e-3 * float(
        cpu.k.abs().max())
    assert abs(float(card.rms) - float(cpu.rms)) <= 1e-3 * float(cpu.rms)
    assert float(card.rms) <= float(card.rms_initial) + 1e-6
    assert abs(float(card.k[0, 0]) - 800) / 800 < 0.01


def _ring(n=64, noise=0.02, seed=2):
    """tests/test_slam_io.py's ring (noisy odometry, an exact loop closure
    of weight 100, chained start), made with the port on the CPU."""
    from compv_tpu_torch.interop import pose_graph_from_numpy
    from compv_tpu_torch.slam.posegraph import compose, relative_pose

    rs = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    true = np.zeros((n, 6), np.float32)
    true[:, 2] = ang
    true[:, 3], true[:, 4] = np.cos(ang), np.sin(ang)
    tt = torch.from_numpy(true)
    j = (np.arange(n) + 1) % n
    rv, tv = relative_pose(tt[:, :3], tt[:, 3:], tt[j, :3], tt[j, 3:])
    meas = torch.cat([rv, tv], 1).numpy()
    meas[j != 0] += rs.normal(0, noise, (n - 1, 6))
    meas = meas.astype(np.float32)
    init = true.copy()
    for i in range(1, n):
        r, t = compose(torch.from_numpy(init[i - 1, :3]),
                       torch.from_numpy(init[i - 1, 3:]),
                       torch.from_numpy(meas[i - 1, :3]),
                       torch.from_numpy(meas[i - 1, 3:]))
        init[i] = torch.cat([r, t]).numpy()
    return pose_graph_from_numpy({
        "poses": init, "edge_i": np.arange(n, dtype=np.int32),
        "edge_j": j.astype(np.int32), "edge_meas": meas,
        "edge_weight": np.where(j == 0, 100.0, 1.0).astype(np.float32),
        "edge_valid": np.ones(n, bool)})


def test_posegraph_on_the_card_is_deterministic_and_matches_cpu(dev):
    """The 64-pose ring: two card runs bit-identical (the sums over edges
    are gathers, no atomics); the final cost within 1e-3 relative of the
    CPU's."""
    from compv_tpu_torch.slam.posegraph import (PoseGraphConfig,
                                                optimize_pose_graph)

    graph = _ring()
    on_card = graph._replace(**{k: v.to(dev) for k, v in
                                graph._asdict().items()})
    a, ca = optimize_pose_graph(on_card, PoseGraphConfig())
    b, cb = optimize_pose_graph(on_card, PoseGraphConfig())
    h, ch = optimize_pose_graph(graph, PoseGraphConfig())
    torch.cuda.synchronize()
    assert torch.equal(a.poses, b.poses) and torch.equal(ca, cb)
    assert abs(float(ca) - float(ch)) <= 1e-3 * float(ch)


def test_q16_blur_and_scaling_cuda_equal_cpu(dev):
    from compv_tpu_torch.image.scale import scale_bicubic, scale_nearest
    from compv_tpu_torch.ops.conv import gaussian_blur_q16

    img = torch.from_numpy(_scene(299, 401))
    on_card = img.to(dev)
    assert torch.equal(gaussian_blur_q16(on_card).cpu(),
                       gaussian_blur_q16(img))
    for fn in (scale_nearest, scale_bicubic):
        assert torch.equal(fn(on_card, 201, 533).cpu(), fn(img, 201, 533))


@pytest.mark.parametrize("angle", [0.0, 17.0, -44.0])
def test_rotate_fast_cuda_matches_cpu(dev, angle):
    """The card's tan and sin may differ from the CPU's by an ulp, which
    moves a shear's lerp weight: values within 1e-2 of 255."""
    from compv_tpu_torch.image.scale import rotate_fast

    img = torch.from_numpy(_scene(120, 200))
    got = rotate_fast(img.to(dev), angle).cpu()
    want = rotate_fast(img, angle)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-2


def test_track_planar_sequence_launches_k1(dev):
    """tests/test_slam_io.py's textured plane, three frames of 4 levels:
    K1 launched 12 times; the chained H finds the shifts."""
    from compv_tpu_torch.slam.pipeline import (PlanarTrackerConfig,
                                               track_planar_sequence)

    from scipy import ndimage

    rs = np.random.default_rng(5)
    base = ndimage.gaussian_filter(
        rs.uniform(0, 255, (200, 280)).astype(np.float32), 1.5)
    base = ((base - base.min()) / np.ptp(base) * 255).astype(np.uint8)
    frames = [np.roll(base, s, axis=1) for s in (0, 4, 8)]
    torch.cuda.synchronize()
    before = fast_kernel.launches
    res = track_planar_sequence(frames, PlanarTrackerConfig(), device=dev)
    torch.cuda.synchronize()
    assert fast_kernel.launches - before == 12
    assert all(res.tracked)
    for h, s in zip(res.h_to_first, (0, 4, 8)):
        assert abs(h[0, 2] - s) < 1.5 and abs(h[1, 2]) < 1.5


def test_fits_cuda_match_cpu(dev):
    """fit_line's inliers equal on the card and the CPU; fit_parabola's
    coefficients within 1e-3 relative (the card's lstsq is QR, gels, of
    the tall full-rank inlier system; the CPU's another LAPACK driver)."""
    from compv_tpu_torch.math.fit import fit_line, fit_parabola

    rs = np.random.default_rng(3)
    n = 4096
    x = rs.uniform(-10, 10, n)
    out = rs.random(n) < 0.3
    y = 0.3 * x ** 2 - 2 * x + 5 + rs.normal(0, 0.1, n)
    y[out] = rs.uniform(0, 60, int(out.sum()))
    par_pts = torch.as_tensor(np.stack([x, y], 1), dtype=torch.float32)
    yl = 0.7 * x + 3 + rs.normal(0, 0.1, n)
    yl[out] = rs.uniform(-20, 20, int(out.sum()))
    line_pts = torch.as_tensor(np.stack([x, yl], 1), dtype=torch.float32)
    card, cpu = fit_line(line_pts.to(dev), threshold=0.5), fit_line(
        line_pts, threshold=0.5)
    assert torch.equal(card.inliers.cpu(), cpu.inliers)
    card, cpu = fit_parabola(par_pts.to(dev), threshold=0.8), fit_parabola(
        par_pts, threshold=0.8)
    assert float((card.abc.cpu() - cpu.abc).abs().max()) <= 1e-3 * float(
        cpu.abc.abs().max())


# ---------------------------------------------------------------- slice 4

@pytest.mark.parametrize("interp", ["nearest", "bilinear", "bilinear_lut"])
def test_hog_cuda_deterministic_and_matches_cpu(dev, interp):
    """HOG at 720x1282: two card runs bit-identical (cell sums over a
    reshape, no atomics); within 2e-6 of the CPU where no pixel's vote
    moved to another bin (counted with one-pixel cells)."""
    from compv_tpu_torch.features.hog import HogConfig, hog_descriptor

    img = torch.from_numpy(_scene(720, 1282))
    cfg = HogConfig(interp=interp)
    a = hog_descriptor(img.to(dev), cfg)
    b = hog_descriptor(img.to(dev), cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    one = HogConfig(cell_size=1, block_size=1, norm="none", interp=interp)
    pa, pb = hog_descriptor(img.to(dev), one).cpu(), hog_descriptor(img, one)
    mag = pb.abs().sum(-1).clamp_min(1.0)
    moved = int(((pa - pb).abs() > 1e-4 * mag[..., None]).any(-1).sum())
    assert moved <= 16
    if moved == 0:
        assert float((a.cpu() - hog_descriptor(img, cfg)).abs().max()) <= 2e-6


def test_slice4_image_ops_cuda_equal_cpu(dev):
    """Color, YUV, 565, HSV, morphology, integer integral images, LUT,
    equalization, projections, adaptive and Wolf thresholds: bit-equal on
    the card and the CPU; the f32 integral of squares within 1e-6."""
    from compv_tpu_torch.image import color, histogram, morph, threshold
    from compv_tpu_torch.image.integral import integral, integral_squared

    gray = torch.from_numpy(_scene(240, 322))
    rgb = torch.stack([gray, gray.roll(3, 0), gray.roll(7, 1)], -1)
    chroma = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, (2, 120, 161), dtype=np.uint8))
    cases = [
        (color.rgb_to_hsv, (rgb,)), (color.rgb_to_hsl, (rgb,)),
        (color.bgr_to_gray, (rgb,)), (color.rgb_to_rgb565, (rgb,)),
        (lambda x: color.rgb565_to_rgb(color.rgb_to_rgb565(x)), (rgb,)),
        (lambda x: torch.stack(color.rgb_to_yuv444(x)), (rgb,)),
        (color.i420_to_rgb, (gray, chroma[0], chroma[1])),
        (color.nv12_to_rgb, (gray, chroma.permute(1, 2, 0).contiguous())),
        (histogram.equalize, (gray,)), (histogram.projection_x, (gray,)),
        (lambda x: histogram.apply_lut256(x, torch.arange(256.0).flip(0)
                                          .to(x.device)), (gray,)),
        (integral, (gray,)), (morph.erode, (gray,)), (morph.close_, (gray,)),
        (morph.black_hat, (gray,)),
        (lambda x: threshold.threshold_adaptive(x, 5, 21), (gray,)),
        (lambda x: threshold.threshold_wolf(x, 41), (gray,)),
    ]
    for fn, args in cases:
        got = fn(*[a.to(dev) for a in args])
        want = fn(*args)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    sq = integral_squared(gray.to(dev)).cpu()
    want = integral_squared(gray)
    assert float((sq - want).abs().max()) <= 1e-6 * float(want.max())


def test_saturating_ops_cuda_equal_cpu(dev):
    from compv_tpu_torch.math import ops

    rs = np.random.default_rng(2)
    for dtype, hi in ((np.uint8, 256), (np.int16, 32768), (np.uint16, 65536),
                      (np.int32, 2 ** 31), (np.uint32, 2 ** 32)):
        lo = 0 if np.iinfo(dtype).min == 0 else -hi
        a = torch.from_numpy(rs.integers(lo, hi, 4096).astype(dtype))
        b = torch.from_numpy(rs.integers(lo, hi, 4096).astype(dtype))
        for op in (ops.add, ops.sub, ops.mul_elementwise):
            got = op(a.to(dev), b.to(dev))
            assert got.dtype == a.dtype and torch.equal(got.cpu(), op(a, b))


def test_svm_pca_knn_cuda_match_cpu(dev):
    """A 200-point RBF SVM: labels equal where |decision| >= 1e-3; PCA
    eigenvalues within 1e-4; KNN indices equal."""
    from compv_tpu_torch.math.pca import pca_compute, pca_project
    from compv_tpu_torch.ml.knn import knn_build, knn_search
    from compv_tpu_torch.ml.svm import (SvmConfig, platt_fit, svm_decision,
                                        svm_train)

    rs = np.random.default_rng(3)
    y = torch.from_numpy(np.where(rs.random(200) < 0.5, 1.0, -1.0)
                         .astype(np.float32))
    x = torch.from_numpy(rs.normal(0, 1, (200, 16)).astype(np.float32)) \
        + y[:, None]
    m, mc = svm_train(x.to(dev), y.to(dev), SvmConfig()), svm_train(
        x, y, SvmConfig())
    dec, dec_cpu = svm_decision(m, x.to(dev)).cpu(), svm_decision(mc, x)
    sure = dec_cpu.abs() >= 1e-3
    assert torch.equal((dec >= 0)[sure], (dec_cpu >= 0)[sure])
    a, b = platt_fit(dec.to(dev), y.to(dev))
    ac, bc = platt_fit(dec_cpu, y)
    assert abs(float(a) - float(ac)) <= 1e-3 * max(1.0, abs(float(ac)))
    p, pc = pca_compute(x.to(dev), 4), pca_compute(x, 4)
    assert float((p.values.cpu() - pc.values).abs().max()) <= 1e-4 * float(
        pc.values.max())
    q = pca_project(pc, x)
    idx = knn_search(knn_build(q.to(dev)), q.to(dev), 3)[0].cpu()
    assert torch.equal(idx, knn_search(knn_build(q), q, 3)[0])


# ---------------------------------------------------------------- slice 5

def test_timer_block_on_synchronizes_a_cuda_result(dev):
    from compv_tpu_torch.profiling import Timer

    a = torch.randn(2048, 2048, device=dev)
    t = Timer()
    out = []
    with t.section("matmuls", block_on=out):
        x = a
        for _ in range(20):
            x = x @ a
        out.append({"x": x})
    assert torch.cuda.current_stream(dev).query()   # nothing left queued
    assert t.counts["matmuls"] == 1


def test_trace_writes_a_file_with_cuda_kernels(dev, tmp_path):
    import json
    import os

    from compv_tpu_torch.profiling import trace

    img = torch.from_numpy(_scene(240, 320)).to(dev)
    fast_kernel.fast_strengths_and_nms(img, 20, 9)
    with trace(str(tmp_path)) as prof:
        fast_kernel.fast_strengths_and_nms(img, 20, 9)    # one K1 launch
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert prof.shortfall == {}
    assert sum("fast_kernel" in name for name in kernels) == 1, kernels[:20]


def test_device_memory_stats_on_the_card(dev):
    from compv_tpu_torch.profiling import device_memory_stats

    keep = torch.empty(1 << 20, dtype=torch.uint8, device=dev)
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    assert torch.cuda.get_device_name(0) in stats[0]["device"]
    assert 0 < stats[0]["bytes_in_use"] < stats[0]["bytes_limit"]
    del keep


def test_draw_from_cuda_results_equals_draw_from_their_cpu_copies(dev):
    from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
    from compv_tpu_torch.viz import draw_keypoints, draw_matches

    cfg = OrbConfig(max_features=500, levels=4)
    a = torch.from_numpy(_scene(240, 320)).to(dev)
    b = torch.roll(a, (3, 5), (0, 1))
    r1, r2 = orb_detect_describe(a, cfg), orb_detect_describe(b, cfg)
    m = knn_match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                  r2.keypoints.valid, k=2)
    ok = ratio_test(m, 0.67)

    def cpu(tree):
        return type(tree)(*[t.cpu() for t in tree])

    got = draw_keypoints(a, r1.keypoints)
    assert np.array_equal(got, draw_keypoints(a.cpu(), cpu(r1.keypoints)))
    got = draw_matches(a, r1.keypoints, b, r2.keypoints, m, ok)
    want = draw_matches(a.cpu().numpy(), cpu(r1.keypoints), b.cpu().numpy(),
                        cpu(r2.keypoints), cpu(m), ok.cpu())
    assert got.shape == (240, 640, 3) and np.array_equal(got, want)


def test_raw_reader_with_reused_buffers_uploads_every_frame(dev, tmp_path):
    from compv_tpu_torch.io import RawYuvReader, VideoWriterRaw
    from compv_tpu_torch.native_rt import native_available

    assert native_available()
    rs = np.random.default_rng(4)
    frames = rs.integers(0, 256, (12, 720 * 1282 * 3 // 2), dtype=np.uint8)
    path = tmp_path / "seq_1282x720.yuv"
    w = VideoWriterRaw(str(path))
    for f in frames:
        w.write(f)
    w.close()
    got = []
    for y in RawYuvReader(str(path), gray=False, reuse_buffers=True):
        got.append(torch.from_numpy(y).to(dev))     # before the recycle
    assert len(got) == 12
    for g, f in zip(got, frames):
        want = f[:720 * 1282].reshape(720, 1282)
        assert np.array_equal(g.cpu().numpy(), want)


# ---------------------------------------------------------------- slice 6

def rank_sharded_detect(mesh, frames):
    from compv_tpu_torch.parallel import sharded_detect
    return mesh.device.type, sharded_detect(torch.from_numpy(frames), mesh,
                                            max_features=256)


def test_sharded_detect_on_two_ranks_of_the_card(dev):
    """Two ranks on one card over gloo: sharded_detect bit-equal to the
    single-process loop, on both ranks."""
    from compv_tpu_torch.parallel import launch, make_mesh, sharded_detect
    frames = np.stack([_scene(240, 320, seed) for seed in range(4)])
    local = sharded_detect(torch.from_numpy(frames),
                           make_mesh(1, device=dev), max_features=256)
    ranks = launch.spawn(rank_sharded_detect, 2, (frames,), backend="gloo",
                         timeout=300)
    for device_type, got in ranks:
        assert device_type == "cuda"
        for a, b in zip(got, local):
            assert torch.equal(a, b.cpu())
