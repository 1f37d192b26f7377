"""The ``text_blobs`` benchmark configuration on the CPU: the port's CCL and
MSER against the benchmark's plain reference (``benchmark/reference/ccl.py``,
``mser.py``) on 120x160 pages of the cell's own recipe, three seeds; the
cell's check at zero on the program, above its limits on the control and
on a program that clips; its generator and its metric readers."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, roofline
from benchmark.probe import Probe
from benchmark.reference import ccl as ref_ccl, mser as ref_mser
from compv_tpu_torch import profiling
from compv_tpu_torch.features import ccl, mser
from compv_tpu_torch.image.threshold import threshold_global

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13)
CELL = "text_blobs.scan1122"
READERS = ("frame_ms_p95.objrec", "ccl_ms_per_frame.text",
           "mser_ms_per_frame.text", "k2b_roofline_pct.text",
           "launches_per_frame.objrec", "device_idle_pct.objrec",
           "host_syncs_per_frame.text")


def small_traffic(pool: int = 1) -> dict:
    p = json.loads((ROOT / "benchmark" / "traffic" / "scan1122.json")
                   .read_text())
    p.update(height=120, width=160, pool=pool)
    return p


def make_pages(seed, pool=1):
    make = harness.load_module(
        ROOT / "benchmark" / "generators" / "text_scan.py",
        "gen_text_scan").make
    return make(small_traffic(pool), seed, "cpu")


@pytest.fixture(scope="module")
def pages():
    return {s: make_pages(s)[0] for s in SEEDS}


def test_pages_repeat_for_a_seed():
    a, b, c = make_pages(7, 2), make_pages(7, 2), make_pages(8, 2)
    assert a.shape == (2, 120, 160) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)
    ink = (a < 128).float().mean()
    assert 0.05 < float(ink) < 0.3          # glyph rows, mostly background


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("connectivity", [8, 4])
def test_ccl_features_match_the_reference(pages, seed, connectivity):
    page = pages[seed]
    res = ccl.ccl_features(threshold_global(page, 127, inverse=True),
                           ccl.CclConfig(connectivity=connectivity,
                                         max_components=512))
    ref = ref_ccl.ccl(page < 128, connectivity)
    assert torch.equal(res.labels.long(), ref.labels)
    assert int(res.num_components) == ref.num and ref.num > 20
    v = res.valid
    assert int(v.sum()) == ref.num
    for f in ("area", "box_x0", "box_y0", "box_x1", "box_y1"):
        assert torch.equal(getattr(res, f)[v].long(), getattr(ref, f)), f
    for f in ("cx", "cy"):                  # one f32 rounding of the quotient
        err = (getattr(res, f)[v].double() - getattr(ref, f)).abs().max()
        assert float(err) <= 160 * 2.0 ** -24


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dark", [True, False])
def test_mser_regions_match_the_reference(pages, seed, dark):
    page = pages[seed]
    cfg = json.loads((ROOT / "benchmark" / "configs" / "text_blobs.json")
                     .read_text())["port_config"]["mser"] | {"dark": dark}
    res = mser.mser_detect(page, mser.MserConfig(**cfg))
    ref = ref_mser.mser(page, cfg)
    k = res.valid
    assert int(res.overflowed) == 0 and int(k.sum()) > 10
    for f in ("seed_x", "seed_y", "level", "area", "box_x0", "box_y0",
              "box_x1", "box_y1"):                       # in rank order
        assert torch.equal(getattr(res, f)[k].long(), getattr(ref, f)), f
    assert torch.equal(res.variation[k], ref.variation)
    rel = (res.variation[k].double() - ref.var64).abs() / ref.var64.clamp(
        min=1e-30)
    assert float(rel.max()) <= 2.0 ** -24


def cell_parts(**port):
    cell = harness.Cell(ROOT, CELL)
    config = json.loads(json.dumps(cell.config))
    config["warmup_requests"] = 1
    for key, val in port.items():
        config["port_config"][key].update(val)
    make = harness.load_module(cell.generator_path, "gen_text_scan").make
    sysmod = harness.load_module(cell.system_path, "bench_system_text")
    return config, make, sysmod


def served(config, make, sysmod, n=2):
    system = sysmod.System(config, small_traffic(pool=2), make, SEEDS[0],
                           "cpu")
    probe = Probe(config["spans"], system.capture, timing=False,
                  device="cpu")
    probe.install()
    try:
        system.setup()
        captured = {}
        for i in range(n):
            recs = []
            with probe.request(recs):
                captured[i] = (recs, system.serve(i))
    finally:
        probe.uninstall()
    return system, captured


def test_the_check_holds_the_program_and_fails_the_control():
    config, make, sysmod = cell_parts()
    system, captured = served(config, make, sysmod)
    numbers = {n["name"]: n for n in system.check(captured)}
    limits = config["check"]["limits"]
    assert set(numbers) == set(limits) and harness.verdict(list(
        numbers.values()))
    exact = ("ccl_label_mismatch_px", "ccl_feature_mismatch",
             "mser_region_mismatch", "capacity_clipped")
    assert all(numbers[k]["value"] == 0 for k in exact)
    # at this size the 128 least variations are all 0 (min_area is 3 px),
    # exact in bfloat16 too: the card's readings hold the control's
    # variations to their limit
    control = system.control_readings(captured)
    assert control["ccl_centroid_err_px"] > limits["ccl_centroid_err_px"]


def swapped(res, first: int, fields):
    """``res`` with its rows ``first`` and ``first + 1`` swapped in every
    field of ``fields``."""
    order = torch.arange(len(res.valid))
    order[first], order[first + 1] = first + 1, first
    return res._replace(**{f: getattr(res, f)[order] for f in fields})


@pytest.mark.parametrize("entry", ["ccl_features", "mser_detect"])
def test_the_check_fails_a_program_that_reorders_ties(entry):
    """Two neighbouring rows of equal area (CCL) or variation (MSER)
    swapped: the same rows, so every paired number holds, in an order
    that breaks the result's stated one."""
    config, make, sysmod = cell_parts()
    system, captured = served(config, make, sysmod, n=1)
    recs, out = captured[0]
    res = {r["fn"]: r["out"] for r in recs}[entry]
    if entry == "ccl_features":
        tied, fields = res.area, ("area", "box_x0", "box_y0", "box_x1",
                                  "box_y1", "cx", "cy", "valid")
        order, rows = "ccl_order_mismatch", "ccl_feature_mismatch"
    else:
        tied, fields = res.variation, mser.MserResult._fields[:-1]
        order, rows = "mser_order_mismatch", "mser_region_mismatch"
    k = int(res.valid.sum())
    first = next(i for i in range(k - 1) if tied[i] == tied[i + 1])
    planted = [dict(r, out=swapped(res, first, fields))
               if r["fn"] == entry else r for r in recs]
    numbers = {n["name"]: n for n in system.check({0: (planted, out)})}
    assert numbers[order]["value"] == 2 and numbers[rows]["value"] == 0
    assert not harness.verdict(list(numbers.values()))
    assert all(n["value"] <= n["limit"] for name, n in numbers.items()
               if name != order)


def test_the_check_fails_a_program_that_clips():
    config, make, sysmod = cell_parts(ccl={"max_components": 16},
                                      mser={"max_candidates": 4})
    system, captured = served(config, make, sysmod, n=1)
    got = {n["name"]: n["value"] for n in system.check(captured)}
    assert got["capacity_clipped"] > 0
    assert got["ccl_feature_mismatch"] > 0 and got["mser_region_mismatch"] > 0


def empty_run():
    return SimpleNamespace(setup_s=1.0, requests=[], t0=0.0, stage_ms={},
                           window_frames=0, slice=None, peaks=None,
                           model_calls={}, models={}, roofline=roofline)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_nothing_on_an_empty_run(name):
    assert harness.Cell(ROOT, CELL).reader(name)(empty_run()) is None


def test_readers_on_a_run():
    cell = harness.Cell(ROOT, CELL)
    m = empty_run()
    m.requests = [(0.0, 0.2, 1, True), (0.2, 0.3, 1, True),
                  (0.3, 0.35, 1, False)]
    m.window_frames = 2
    m.stage_ms = {"ccl": 4.0, "mser": 90.0}
    assert cell.reader("frame_ms_p95.objrec")(m) == float("inf")
    assert cell.reader("ccl_ms_per_frame.text")(m) == pytest.approx(2.0)
    assert cell.reader("mser_ms_per_frame.text")(m) == pytest.approx(45.0)
    m.slice = {"busy_s": 0.5, "window_s": 2.0, "kernels": 1000, "frames": 4,
               "by_stage": {"k2b": {"device_ns": 10_000, "kernels": 1}}}
    m.peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    m.models = {"k2b": "k2b_seeded_label"}
    m.model_calls = {"k2b": [(torch.zeros((1182, 1122), dtype=torch.bool),
                              None, 8)]}
    # 9 B a pixel of 1122 x 1182 at 3.35 TB/s over 10 us
    want = 100.0 * 9 * 1122 * 1182 / 3.35e12 / 10e-6
    assert cell.reader("k2b_roofline_pct.text")(m) == pytest.approx(want)
    assert cell.reader("launches_per_frame.objrec")(m) == 250
    assert cell.reader("device_idle_pct.objrec")(m) == pytest.approx(75.0)
    page = make_pages(SEEDS[0])[0][:48, :64]
    ccl.ccl_features(page < 128)
    mser.mser_detect(page)
    counts = profiling.host_syncs()
    want = sum(counts[e]["syncs"] / counts[e]["calls"]
               for e in ("ccl_features", "mser_detect"))
    assert cell.reader("host_syncs_per_frame.text")(m) == want
