"""The port's own spans (``compv_tpu_torch.profiling.span``): off by
default and then recording nothing, the tree ``match_pair`` records when
the store is on, the self-time helpers, the clock they share with
``torch.profiler``, and outputs that do not depend on the store."""
import threading

import numpy as np
import pytest
import torch

from compv_tpu_torch import profiling
from compv_tpu_torch.features.orb import PATCH_DIAMETER, OrbConfig
from compv_tpu_torch.image.pyramid import pyramid_sizes
from compv_tpu_torch.profiling import SpanRecord
from compv_tpu_torch.slam import frontend

# 96x128 over 8 levels: levels 6 and 7 are too small for a patch
CFG = frontend.FrontendConfig(orb=OrbConfig(max_features=200, levels=8))


def _images():
    rs = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    img = ((xx // 12 + yy // 12) % 2 * 180 + 30
           + rs.normal(0, 3, (96, 128))).clip(0, 255).astype(np.uint8)
    a = torch.from_numpy(img)
    return a, torch.roll(a, (2, 3), (0, 1))


def _kept_levels():
    sizes = pyramid_sizes(96, 128, CFG.orb.levels, CFG.orb.scale_factor)
    return [lv for lv, (h, w) in enumerate(sizes)
            if min(h, w) >= PATCH_DIAMETER + 2]


@pytest.fixture
def store():
    profiling.spans.disable()
    profiling.spans.take()
    yield profiling.spans
    profiling.spans.disable()
    profiling.spans.take()


def test_store_off_records_nothing(store):
    frontend.match_pair(*_images(), CFG)
    assert store.take() == []
    with pytest.raises(ValueError):         # an off span lets errors through
        with profiling.span("x", level=1):
            raise ValueError("passes")


def test_match_pair_records_its_tree(store):
    store.enable()
    frontend.match_pair(*_images(), CFG)
    recs = store.take()
    assert store.take() == []                       # take() clears
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    assert {r.request for r in recs} == {recs[-1].id}
    root = recs[-1]                                  # the last to close
    assert root.name == "frontend.match_pair" and root.parent is None

    def parent(r):
        return by_id[r.parent].name

    kept = _kept_levels()
    assert kept == [0, 1, 2, 3, 4, 5]
    orbs = [r for r in recs if r.name == "orb"]
    assert len(orbs) == 2 and all(parent(r) == root.name for r in orbs)
    for o in orbs:
        kids = [r for r in recs if r.parent == o.id]
        by_name = {}
        for r in kids:
            by_name.setdefault(r.name, []).append(r.attrs.get("level"))
        assert by_name == {"orb.pyramid": kept[1:],
                           "orb.detect": kept, "orb.orient": kept,
                           "orb.describe": kept,
                           "orb.assemble": kept + [None]}
    for name in ("match.knn", "match.ratio", "homography"):
        (r,) = [r for r in recs if r.name == name]
        assert parent(r) == root.name
    own = profiling.span_self_ns(recs)
    for r in recs:
        assert own[r.id] >= 0 and r.end_ns >= r.start_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    totals = profiling.span_totals(recs)
    assert totals["orb.detect"]["calls"] == 2 * len(kept)
    assert totals["frontend.match_pair"]["total_ns"] == (root.end_ns
                                                         - root.start_ns)
    assert sum(t["self_ns"] for t in totals.values()) == (root.end_ns
                                                          - root.start_ns)


def test_outputs_do_not_depend_on_the_store(store):
    off = frontend.match_pair(*_images(), CFG)
    store.enable()
    on = frontend.match_pair(*_images(), CFG)
    assert store.take()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_self_time_is_what_children_leave():
    recs = [SpanRecord(1, None, 1, "a", 0, 100, {}),
            SpanRecord(2, 1, 1, "b", 10, 30, {}),
            SpanRecord(3, 1, 1, "b", 25, 40, {}),       # overlaps its sibling
            SpanRecord(4, 2, 1, "c", 12, 14, {"level": 2}),
            SpanRecord(5, 1, 1, "d", 90, 120, {})]      # runs past its parent
    assert profiling.span_self_ns(recs) == {1: 100 - 30 - 10, 2: 18, 3: 15,
                                            4: 2, 5: 30}
    assert profiling.span_totals(recs)["b"] == {"calls": 2, "total_ns": 35,
                                                "self_ns": 33}


def test_each_thread_keeps_its_own_stack(store):
    store.enable()
    seen = []

    def work():
        with profiling.span("worker"):
            pass
        seen.append(True)

    with profiling.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and seen
    recs = {r.name: r for r in store.take()}
    assert recs["worker"].parent is None
    assert recs["worker"].request == recs["worker"].id
    assert recs["main"].request == recs["main"].id != recs["worker"].id


def test_a_span_shares_the_profilers_clock(store):
    """A span and a ``record_function`` range opened back to back in a CPU
    profiler window start within 1 ms of each other."""
    from torch.profiler import ProfilerActivity, profile

    store.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with profiling.span("probe", i=i):
                with torch.autograd.profiler.record_function(f"probe{i}"):
                    torch.ones(8).add_(1)
    ranges = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    spans = {r.attrs["i"]: r.start_ns for r in store.take()}
    gaps = [abs(ranges[f"probe{i}"] - spans[i]) for i in range(1, 6)]
    assert max(gaps) < 1_000_000, gaps          # the first range warms up
