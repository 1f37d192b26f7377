"""The port's spans and host-sync counter on the text-blob path
(``ccl_features``, ``mser_detect``): the tree one page records with the
store on, nothing with it off, and the counter against each entry's
own count."""
import numpy as np
import pytest
import torch

from compv_tpu_torch import profiling
from compv_tpu_torch.features import ccl, mser
from compv_tpu_torch.image.threshold import threshold_global


def _page():
    """96x128 of dark glyph-like strokes on a bright, noisy page."""
    rs = np.random.default_rng(5)
    page = np.full((96, 128), 235.0)
    for row in range(8, 84, 13):
        for col in range(6, 112, 20):
            glyph = rs.random((8, 14)) < 0.45
            glyph[:, 1:] |= glyph[:, :-1]
            page[row:row + 8, col:col + 14][glyph] = 20
    page += rs.normal(0, 3, page.shape)
    return torch.from_numpy(page.clip(0, 255).astype(np.uint8))


@pytest.fixture
def store():
    profiling.spans.disable()
    profiling.spans.take()
    yield profiling.spans
    profiling.spans.disable()
    profiling.spans.take()


def _serve(page):
    binary = threshold_global(page, 127, inverse=True)
    return ccl.ccl_features(binary), mser.mser_detect(page)


def test_one_page_records_its_tree(store):
    store.enable()
    _serve(_page())
    recs = store.take()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["ccl", "mser"]
    kids = {root.name: [r for r in recs if r.parent == root.id]
            for root in roots}
    assert [r.name for r in kids["ccl"]] == [
        "ccl.label", "ccl.runs", "ccl.compact", "ccl.stats"]
    levels = [r for r in kids["mser"] if r.name == "mser.level"]
    assert [r.attrs["level"] for r in levels] == list(range(5, 256, 5))
    assert [r.name for r in kids["mser"]][-1] == "mser.stability"
    assert len(kids["mser"]) == 52
    assert all(by_id[r.parent].name in ("ccl", "mser") for r in recs
               if r.parent is not None)
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_store_off_records_nothing_and_changes_nothing(store):
    page = _page()
    off = _serve(page)
    assert store.take() == []
    store.enable()
    on = _serve(page)
    for a, b in zip(off, on):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name


def test_the_counter_adds_each_call_syncs():
    page = _page()
    before = profiling.host_syncs()
    _serve(page)
    after = profiling.host_syncs()

    def gained(entry):
        b = before.get(entry, {"calls": 0, "syncs": 0})
        return (after[entry]["calls"] - b["calls"],
                after[entry]["syncs"] - b["syncs"])

    # the run-record path: the row overflow test and K3's capacity test
    assert gained("ccl_features") == (1, 2)
    # the ladder's skip tests and tier choices, and the overflow read
    assert mser.last_syncs >= 51
    assert gained("mser_detect") == (1, mser.last_syncs + 1)
