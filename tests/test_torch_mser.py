"""Port parity for MSER (``features/mser.py``), the seeded labeling ladder's
consumer, against ``compv_tpu`` on the same numpy inputs: the golden crop
and a 96x128 crop of bench.py's text scene, dark and bright, plus
``mser_region_mask``, ``mser_region_points``, the table lookup and the
overflow report. Tolerances: integer fields exact; ``variation`` within
1e-6 relative (the same f32 quotient of exact integers on both sides; inf
where no region). The locked ``mser_summary`` golden is met."""
import importlib.util
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.features import mser as jmser
from compv_tpu_torch.core import golden
from compv_tpu_torch.features import mser
from compv_tpu_torch.interop import config_from_reference, result_from_numpy
from tests.fixtures import make_test_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def text_crop():
    """96x128 of bench.py's 1122x1182 text scene (glyph rows, antialias and
    sensor noise), loaded by path: bench.py's module level imports numpy
    only."""
    spec = importlib.util.spec_from_file_location(
        "compv_bench", os.path.join(_ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return np.ascontiguousarray(bench._images()[1][14:110, 10:138])


def _assert_same(got, want):
    for name in mser.MserResult._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name == "variation":
            assert g.dtype == np.float32
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _run_both(img, cfg):
    got = mser.mser_detect(torch.from_numpy(img), config_from_reference(cfg))
    want = jmser.mser_detect(jnp.asarray(img), cfg)
    return got, want


@pytest.mark.parametrize("dark", [True, False])
def test_mser_golden_crop(goldens, dark):
    img = make_test_image()[:160, :224]
    got, want = _run_both(img, jmser.MserConfig(max_regions=64, dark=dark))
    _assert_same(got, want)
    if dark:
        assert golden.mser_summary(got) == goldens["mser_summary"]


@pytest.mark.parametrize("dark", [True, False])
def test_mser_text_crop(text_crop, dark):
    got, want = _run_both(text_crop, jmser.MserConfig(dark=dark))
    _assert_same(got, want)
    if dark:
        assert int(got.valid.sum()) > 0          # glyphs are found
    # the ladder synced twice per changed level and once per skipped one
    assert mser.last_syncs >= 51


def test_mser_region_mask_and_points(text_crop):
    res = mser.mser_detect(torch.from_numpy(text_crop))
    v = np.nonzero(res.valid.numpy())[0]
    assert len(v) > 0
    for i in v[:4]:
        sx, sy, lv = int(res.seed_x[i]), int(res.seed_y[i]), int(res.level[i])
        got = mser.mser_region_mask(torch.from_numpy(text_crop), sx, sy, lv)
        want = np.asarray(jmser.mser_region_mask(jnp.asarray(text_crop), sx,
                                                 sy, lv))
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == int(res.area[i])
        for cap in (16, 4096):
            gp = mser.mser_region_points(got, cap)
            wp = jmser.mser_region_points(jnp.asarray(want), cap)
            for g, w in zip(gp, wp):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mser_region_mask_bright():
    img = np.full((40, 50), 30, np.uint8)
    img[10:25, 12:30] = 230
    got = mser.mser_region_mask(torch.from_numpy(img), 15, 12, 40, dark=False)
    want = jmser.mser_region_mask(jnp.asarray(img), 15, 12, 40, dark=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 15 * 18


def test_mser_overflow_reported(text_crop, caplog):
    """A candidate capacity below what a level holds is flagged in
    `overflowed`, as the reference flags it, and logged."""
    cfg = jmser.MserConfig(max_candidates=4)
    with caplog.at_level(logging.WARNING, logger=mser.__name__):
        got, want = _run_both(text_crop, cfg)
    assert int(got.overflowed) == int(want.overflowed) > 0
    assert "overflow" in caplog.text
    _assert_same(got, want)


def test_lookup_sorted_matches_reference():
    rs = np.random.default_rng(12)
    invalid = 10 ** 6
    keys = np.sort(rs.choice(5000, (3, 40), replace=False), axis=1)
    keys[:, 30:] = invalid
    keys = keys.astype(np.int32)
    vals = rs.integers(0, 1 << 20, (3, 40)).astype(np.int32)
    queries = np.concatenate([keys[:, :20], rs.integers(0, 5000, (3, 20)),
                              np.full((3, 4), invalid)], 1).astype(np.int32)
    found, got = mser._lookup_sorted(torch.from_numpy(keys),
                                     torch.from_numpy(vals),
                                     torch.from_numpy(queries), invalid)
    jfound, jvals = jmser._lookup_sorted(jnp.asarray(keys), jnp.asarray(vals),
                                         jnp.asarray(queries), invalid)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    f = found.numpy()
    np.testing.assert_array_equal(got.numpy()[f], np.asarray(jvals)[f])


def test_quantize_var_matches_reference():
    v = np.array([0.0, 1e-7, 0.3, 0.5, 2.5, 7999.9, 8000.0, 1e9, np.inf,
                  0.5 / 65536], np.float32)
    np.testing.assert_array_equal(
        mser._quantize_var(torch.from_numpy(v)).numpy(),
        np.asarray(jmser._quantize_var(jnp.asarray(v))))


def test_mser_interop(text_crop):
    cfg = jmser.MserConfig(delta=4, run_tiers=(64, 200), dark=False)
    port_cfg = config_from_reference(cfg)
    assert port_cfg == mser.MserConfig(delta=4, run_tiers=(64, 200),
                                       dark=False)
    want = jmser.mser_detect(jnp.asarray(text_crop[:48, :64]), cfg)
    moved = result_from_numpy(mser.MserResult, want)
    assert moved.variation.dtype == torch.float32
    assert moved.level.dtype == torch.int32
    _assert_same(mser.mser_detect(torch.from_numpy(text_crop[:48, :64]),
                                  port_cfg), want)
    _assert_same(moved, want)
