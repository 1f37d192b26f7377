"""MSER's ladder level areas (``ops/kernels/level_areas.py``,
``csrc/level_areas.cu``, K7).

On the CPU, where the kernel cannot run: the wrapper's twin against the
ladder's area chain as ``features/mser.py`` ran it before K7 (the tier
choice and ``_level_candidates``, copied below) on every ladder level of
the text crop; a NumPy model of the kernel's passes (warp steps grouped
by label, one pending count a lane, block counts, an ordered scatter)
against the twin, and its atomics on a one-component level; the wrapper's
argument checks and its routing of CPU tensors to the twin.

On the card (marked ``cuda``, skipped without one): the kernel against
the twin, ``torch.equal`` on root, area and over, on every ladder level of
two pages of the ``text_blobs.scan1122`` cell's generator, on an
all-background and an all-foreground level, past ``cap``, at odd shapes,
at ``amin`` 1; ``mser_detect`` on the card against the CPU; one page's
ladder launching K7 once a changed level. From the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_level_areas.py
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from compv_tpu_torch.features import mser
from compv_tpu_torch.features.ccl import extract_runs, label_components
from compv_tpu_torch.ops.kernels import _build
from compv_tpu_torch.ops.kernels import level_areas as la

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "compv_tpu_torch" / "csrc" / "level_areas.cu"
CONFIG = mser.MserConfig()


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _text_crop() -> np.ndarray:
    """tests/test_torch_mser.py's 96x128 crop of bench.py's text scene."""
    bench = _load("compv_bench", ROOT / "bench.py")
    return np.ascontiguousarray(bench._images()[1][14:110, 10:138])


def _labels(binary: torch.Tensor) -> torch.Tensor:
    n = binary.numel()
    return label_components(binary, 8, max(n, 64))


def _ladder_labels(img: torch.Tensor, dark: bool = True):
    """The (H, W) labels of every level of MSER's ladder on ``img``."""
    f = img if dark else (255 - img.to(torch.int32)).to(torch.uint8)
    return [_labels(f.to(torch.int32) <= t)
            for t in mser.ladder_levels(CONFIG)[2]]


def _mser_bounds(h: int, w: int):
    """(amin, cap) as ``mser_detect`` gives them at the defaults."""
    cap = min(CONFIG.max_candidates,
              h * la.run_tiers(h, w, CONFIG.run_tiers)[0])
    return max(int(CONFIG.min_area * h * w), 1), cap


def _outputs(cap: int, device):
    return (torch.full((cap,), 7, dtype=torch.int32, device=device),
            torch.full((cap,), 7, dtype=torch.int32, device=device),
            torch.full((), 7, dtype=torch.int32, device=device))


def _call(lbl, amin, cap, buf=None):
    root, area, over = _outputs(cap, lbl.device)
    la.level_candidates(lbl, amin, cap, root, area, over, buf)
    return root, area, over


# ------------------------------------------------------------------ CPU

_BIG = 1 << 30
_U32_SENT = 0xFFFFFFFF


def _old_level_candidates(lbl, amin, cap):
    """The ladder's area chain of one changed level as ``_mser_impl`` ran
    it before K7: the tier choice, then ``_level_candidates``."""
    h, w = lbl.shape
    n = h * w
    w_exact = -(-w // 2)
    sum_cap = max((2 ** 31 - 1) // (h * max(w, 1)), 1)
    tiers = sorted({min(t, w_exact, sum_cap) for t in CONFIG.run_tiers}
                   | {min(w_exact, sum_cap)})
    lb_bits = max(1, (n - 1).bit_length())
    len_bits = max(1, w.bit_length())
    fgl = lbl >= 0
    starts = fgl & ~F.pad(fgl, (1, 0), value=False)[:, :-1]
    mx = int(starts.sum(dim=1).max()) if h else 0
    kk = tiers[sum(int(mx > t_) for t_ in tiers[:-1])]

    run_lbl, run_x0, run_x1, counts = extract_runs(lbl, kk)
    over_runs = (counts > kk).any()
    live = run_lbl >= 0
    length = torch.where(live, run_x1 - run_x0 + 1, 0)
    keyu = torch.where(live, (run_lbl.to(torch.int64) << len_bits)
                       | length.to(torch.int64), _U32_SENT).reshape(-1)
    ku = torch.sort(keyu).values
    sen = ku == _U32_SENT
    ks = torch.where(sen, _BIG, ku >> len_bits)
    ln = torch.where(sen, 0, ku & ((1 << len_bits) - 1))
    is_first = (ks != F.pad(ks, (1, 0), value=-1)[:-1]) & (ks < _BIG)
    cs = torch.cumsum(ln, 0)
    exc = F.pad(cs, (1, 0))[:-1]
    u = torch.where(is_first, exc, 2 ** 62)
    nxt = torch.cummin(u.flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt[1:], cs[-1:]])
    area = torch.minimum(nxt, cs[-1]) - exc
    cand_mask = is_first & (area >= amin)
    ckey = torch.where(cand_mask, ks, _BIG)
    root_s, order = torch.sort(ckey, stable=True)
    area_s = torch.where(cand_mask, area, 0)[order]
    root = torch.where(root_s[:cap] < _BIG, root_s[:cap], -1)
    car = torch.where(root >= 0, area_s[:cap], 0)
    over = (over_runs | (cand_mask.sum() > cap)).to(torch.int32)
    return root.to(torch.int32), car.to(torch.int32), over


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"{name} is not a literal in {SOURCE.name}"
    return int(m.group(1))


def _model(lbl: np.ndarray, amin: int, cap: int):
    """The kernel's three passes in NumPy: (root, area, over, atomics)."""
    steps, items = _constant("kCountSteps"), _constant("kScanItems")
    block = _constant("kScanThreads") * items
    flat = lbl.reshape(-1).astype(np.int64)
    n = flat.size
    table = np.zeros(n, np.int64)
    atomics = 0
    for base in range(0, n, 32 * steps):          # one warp
        held, count = [-1] * 32, [0] * 32
        for s in range(steps):
            p = base + s * 32 + np.arange(32)
            lab = np.where(p < n, flat[np.minimum(p, n - 1)], -1)
            lab = np.where(lab < n, lab, -1)
            for v in np.unique(lab[lab >= 0]):
                lanes = np.flatnonzero(lab == v)
                lead = lanes[0]
                if held[lead] == v:
                    count[lead] += lanes.size
                else:
                    if held[lead] >= 0:
                        table[held[lead]] += count[lead]
                        atomics += 1
                    held[lead], count[lead] = v, lanes.size
        for lane in range(32):
            if held[lane] >= 0:
                table[held[lane]] += count[lane]
                atomics += 1
    nb = max(1, -(-n // block))
    counts = [int((table[b * block:(b + 1) * block] >= amin).sum())
              for b in range(nb)]
    root = np.full(cap, -1, np.int64)
    area = np.zeros(cap, np.int64)
    for b in range(nb):
        rank = sum(counts[:b])
        for j in range(b * block, min((b + 1) * block, n)):
            if table[j] >= amin:
                if rank < cap:
                    root[rank], area[rank] = j, table[j]
                rank += 1
    return root, area, int(sum(counts) > cap), atomics


@pytest.fixture(scope="module")
def crop_levels():
    return _ladder_labels(torch.from_numpy(_text_crop()))


@pytest.mark.parametrize("amin", ["mser", 1])
def test_twin_equals_the_ladders_area_chain_on_the_text_crop(crop_levels,
                                                             amin):
    h, w = crop_levels[0].shape
    a_mser, cap = _mser_bounds(h, w)
    amin = a_mser if amin == "mser" else amin
    clipped = 0
    for lbl in crop_levels:
        got = _call(lbl, amin, cap)
        want = _old_level_candidates(lbl, amin, cap)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        clipped += int(got[2])
    if amin == a_mser:
        assert clipped == 0


@pytest.mark.parametrize("amin", ["mser", 1])
def test_model_of_the_kernel_equals_the_twin_on_the_text_crop(crop_levels,
                                                              amin):
    h, w = crop_levels[0].shape
    a_mser, cap = _mser_bounds(h, w)
    amin = a_mser if amin == "mser" else amin
    for lbl in crop_levels[::5] + crop_levels[-3:]:
        root, area, over, _ = _model(lbl.numpy(), amin, cap)
        want = _call(lbl, amin, cap)
        assert np.array_equal(root, want[0].numpy())
        assert np.array_equal(area, want[1].numpy())
        assert over == int(want[2])


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (7, 7),
                                   (31, 33), (33, 47), (40, 64)])
@pytest.mark.parametrize("amin,cap", [(1, 1), (1, 8), (2, 64), (5, 1024)])
def test_model_of_the_kernel_equals_the_twin_at_odd_shapes(shape, amin,
                                                           cap):
    rs = np.random.default_rng(sum(shape) * 31 + amin)
    lbl = _labels(torch.from_numpy(rs.random(shape) < 0.45))
    root, area, over, _ = _model(lbl.numpy(), amin, cap)
    want = _call(lbl, amin, cap)
    assert np.array_equal(root, want[0].numpy())
    assert np.array_equal(area, want[1].numpy())
    assert over == int(want[2])


def test_model_adds_once_a_warp_on_one_component():
    """The contention case: one component of H * W pixels takes one atomic
    a warp, not one a pixel."""
    h, w = 64, 80
    lbl = np.zeros((h, w), np.int32)
    root, area, over, atomics = _model(lbl, 1, 4)
    assert atomics == -(-h * w // (32 * _constant("kCountSteps")))
    assert root.tolist() == [0, -1, -1, -1]
    assert area.tolist() == [h * w, 0, 0, 0] and over == 0
    want = _call(torch.from_numpy(lbl), 1, 4)
    assert want[0].tolist() == root.tolist() and int(want[2]) == 0


def test_cpu_tensors_go_to_the_twin_without_a_launch(crop_levels):
    lbl = crop_levels[20]
    amin, cap = _mser_bounds(*lbl.shape)
    before = _build.launch_counts()
    got = _call(lbl, amin, cap)
    assert _build.launch_counts() == before
    assert torch.equal(got[0], la._level_candidates_ref(lbl, amin, cap)[0])
    assert la.scratch(lbl.numel(), "cpu").numel() == 0


def _rejections():
    lbl = torch.full((4, 6), -1, dtype=torch.int32)
    root, area, over = _outputs(8, "cpu")
    ok = (lbl, 1, 8, root, area, over)

    def but(i, v):
        args = list(ok)
        args[i] = v
        return tuple(args)
    return {
        "lbl int64": but(0, lbl.long()),
        "lbl 1-D": but(0, lbl.reshape(-1)),
        "lbl 3-D": but(0, lbl.reshape(1, 4, 6)),
        "lbl not contiguous": but(0, lbl.t()),
        "lbl not a tensor": but(0, lbl.numpy()),
        "lbl on another device": but(0, torch.full((4, 6), -1,
                                                   dtype=torch.int32,
                                                   device="meta")),
        "all on the meta device": (lbl.to("meta"), 1, 8, root.to("meta"),
                                   area.to("meta"), over.to("meta")),
        "cap 0": (lbl, 1, 0, root[:0], area[:0], over),
        "cap not an int": but(2, 8.0),
        "amin 0": but(1, 0),
        "root float": but(3, root.float()),
        "root of another length": but(3, root[:7]),
        "root not contiguous": but(3, torch.zeros((16,), dtype=torch.int32
                                                  )[::2]),
        "area int64": but(4, area.long()),
        "over of two elements": but(5, torch.zeros((2,), dtype=torch.int32)),
        "over bool": but(5, over.bool()),
    }


@pytest.mark.parametrize("case", list(_rejections()))
def test_the_wrapper_rejects_what_it_does_not_take(case):
    args = _rejections()[case]
    before = _build.launch_counts()
    with pytest.raises((ValueError, TypeError)):
        la.level_candidates(*args)
    assert _build.launch_counts() == before


def test_the_ladder_asks_for_one_table_a_changed_level(monkeypatch,
                                                       crop_levels):
    """mser_detect hands K2b's labels of each changed level to
    level_candidates once, with mser's amin and cap, and syncs once a
    level."""
    seen, k2b, real = [], [], la.level_candidates
    real_k2b = mser.label_components_seeded

    def spy(lbl, amin, cap, *rest):
        seen.append((lbl.clone(), amin, cap))
        return real(lbl, amin, cap, *rest)

    def spy_k2b(*a, **k):
        k2b.append(1)
        return real_k2b(*a, **k)
    monkeypatch.setattr(la, "level_candidates", spy)
    monkeypatch.setattr(mser, "label_components_seeded", spy_k2b)
    mser.mser_detect(torch.from_numpy(_text_crop()))
    assert len(seen) == len(k2b) > 0
    assert mser.last_syncs == len(mser.ladder_levels(CONFIG)[2])
    amin, cap = _mser_bounds(96, 128)
    assert {(a, c) for _, a, c in seen} == {(amin, cap)}
    labelled = [lv for i, lv in enumerate(crop_levels)
                if i == 0 or not torch.equal(lv >= 0, crop_levels[i - 1] >= 0)]
    labelled = [lv for lv in labelled if bool((lv >= 0).any())]
    assert len(labelled) == len(seen)
    for (lbl, _, _), want in zip(seen, labelled):
        assert torch.equal(lbl, want)


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _equal_to_twin(lbl, amin, cap, buf=None):
    got = _call(lbl, amin, cap, buf)
    want = la._level_candidates_ref(lbl, amin, cap)
    for name, g, x in zip(("root", "area", "over"), got, want):
        assert torch.equal(g, x.reshape(g.shape)), name
    return got


def _scan_pages(device, seed: int, pool: int = 2) -> torch.Tensor:
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "scan1122.json")
                         .read_text())
    traffic["pool"] = pool
    gen = _load("gen_text_scan", ROOT / "benchmark" / "generators"
                / "text_scan.py")
    return gen.make(traffic, seed, device)


@pytest.mark.cuda
@pytest.mark.parametrize("amin", ["mser", 1])
def test_kernel_equals_twin_on_every_level_of_two_scan_pages(dev, amin):
    pages = _scan_pages(dev, 2 ** 31 + 2201)
    h, w = pages.shape[1:]
    a_mser, cap = _mser_bounds(h, w)
    amin = a_mser if amin == "mser" else amin
    buf = la.scratch(h * w, dev)
    over = []
    for page in pages:
        for lbl in _ladder_labels(page):
            over.append(int(_equal_to_twin(lbl, amin, cap, buf)[2]))
    assert len(over) == 2 * len(mser.ladder_levels(CONFIG)[2])
    assert not any(over) if amin == a_mser else any(over)
    assert not bool(buf[:h * w].any())  # left zeroed for the next level


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all background", "all foreground",
                                  "past cap", "amin 1 on the text crop"])
def test_kernel_equals_twin_on_edge_levels(dev, case):
    h, w = 1182, 1122
    if case == "all background":
        lbl = torch.full((h, w), -1, dtype=torch.int32, device=dev)
        got = _equal_to_twin(lbl, 265, 1024)
        assert int(got[2]) == 0 and bool((got[0] == -1).all())
    elif case == "all foreground":
        lbl = torch.zeros((h, w), dtype=torch.int32, device=dev)
        got = _equal_to_twin(lbl, 265, 1024)
        assert got[0][0] == 0 and got[1][0] == h * w and int(got[2]) == 0
    elif case == "past cap":
        grid = torch.zeros((301, 257), dtype=torch.bool, device=dev)
        grid[::2, ::2] = True                   # 151 x 129 lone pixels
        lbl = _labels(grid)
        got = _equal_to_twin(lbl, 1, 16)
        assert int(got[2]) == 1
        assert got[0].tolist() == [2 * k for k in range(16)]
    else:
        for lbl in _ladder_labels(torch.from_numpy(_text_crop()).to(dev)):
            _equal_to_twin(lbl, 1, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (2, 3), (5, 5),
                                   (17, 31), (31, 33), (33, 47)])
@pytest.mark.parametrize("fill", [0.0, 0.45, 1.0])
def test_kernel_equals_twin_at_odd_shapes(dev, shape, fill):
    rs = np.random.default_rng(sum(shape) + int(fill * 100))
    lbl = _labels(torch.from_numpy(rs.random(shape) < fill).to(dev))
    for amin, cap in ((1, 1), (1, 4), (2, 64), (3, 1024)):
        _equal_to_twin(lbl, amin, cap)


@pytest.mark.cuda
def test_kernel_counts_its_launches_and_repeats(dev):
    lbl = _labels(torch.from_numpy(_text_crop() < 128).to(dev))
    before = _build.launch_counts()["level_areas"]
    a = _call(lbl, 1, 1024)
    b = _call(lbl, 1, 1024, la.scratch(lbl.numel(), dev))
    assert _build.launch_counts()["level_areas"] == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    small = torch.zeros((8,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        _call(lbl, 1, 1024, small)
    assert _build.launch_counts()["level_areas"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dark", [True, False])
def test_mser_cuda_equals_cpu_on_the_text_crop(dev, dark):
    img = torch.from_numpy(_text_crop())
    cfg = mser.MserConfig(dark=dark)
    a = mser.mser_detect(img, cfg)
    b = mser.mser_detect(img.to(dev), cfg)
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y.cpu()), name


@pytest.mark.cuda
def test_mser_cuda_equals_cpu_on_the_bright_text_case(dev):
    pc = _load("parity_cases", ROOT / "tests" / "test_torch_parity_cases.py")
    case = next(c for c in pc.cases("features")
                if c.fn == "mser_detect" and c.tag == "bright_text")
    a = pc.run_port(case, "cpu")
    assert a[0] == "ok"
    np.testing.assert_equal(pc.run_port(case, "cuda"), a)


@pytest.mark.cuda
def test_one_scan_page_launches_k7_once_a_changed_level(dev):
    from compv_tpu_torch.profiling import hand_kernel_launches

    page = _scan_pages(dev, 2 ** 31 + 2203, pool=1)[0]
    fg = [page <= t for t in mser.ladder_levels(CONFIG)[2]]
    changed = sum(int(bool(a.any())) if i == 0 else
                  int(not torch.equal(a, fg[i - 1])) for i, a in enumerate(fg))
    before = hand_kernel_launches()
    mser.mser_detect(page, mser.MserConfig())
    after = hand_kernel_launches()
    got = {k: after[k] - before[k] for k in after}
    assert got["level_areas"] == got["merge_seeded"] == changed
    assert changed in (49, 50)      # a page of the cell: 49 or 50
    assert mser.last_syncs == 51
