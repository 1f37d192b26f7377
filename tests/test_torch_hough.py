"""Port parity for the Hough path: ``hough_sht``, ``hough_sht_stats``,
``hough_kht``, ``hough_lines_to_cartesian``, the ``lines_summary`` copy and
the ``Lines`` / config conversions, against ``compv_tpu`` on the same numpy
inputs (CPU; the accumulator runs K4's twin).

Tolerances: ``hough_sht`` is exact in all four ``Lines`` fields (the
reference's trig table, the same f32 rho arithmetic, integer votes, stable
top-k ties), and meets the golden ``hough_sht_summary``. ``hough_kht`` takes
its orientation from ``torch.atan2``, which may differ from XLA's
``arctan2`` by an ulp and so move a point's centre theta bin: the test
counts the points that move (none on these images) and, when none does,
requires exact equality; otherwise each moved point may shift at most 2
votes. ``hough_lines_to_cartesian`` uses ``torch.cos`` / ``torch.sin``:
within 1e-3 px.
"""
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.core import golden as jgolden
from compv_tpu.core.types import Lines as JLines
from compv_tpu_torch.core import golden
from compv_tpu_torch.core.types import Lines
from compv_tpu_torch.interop import (config_from_reference, result_from_numpy,
                                     result_to_numpy)
from tests.fixtures import make_test_image

hough = importlib.import_module("compv_tpu_torch.features.hough")
canny = importlib.import_module("compv_tpu_torch.features.canny")
edges = importlib.import_module("compv_tpu_torch.features.edges")
jhough = importlib.import_module("compv_tpu.features.hough")
jcanny = importlib.import_module("compv_tpu.features.canny")
jedges = importlib.import_module("compv_tpu.features.edges")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines_img():
    """Two straight lines (tests/test_edges.py:22-28)."""
    img = np.zeros((80, 100), np.uint8)
    img[20, 5:95] = 255
    img[5:75, 40] = 255
    return img


def _dense_map():
    """The dense 480x640 map of tests/test_edges.py:147-155."""
    rs = np.random.default_rng(3)
    img = np.zeros((480, 640), np.uint8)
    img[rs.uniform(size=img.shape) < 0.12] = 255
    img[40, :] = 255
    img[:, 200] = 255
    return img


def _golden_edges():
    return np.asarray(jcanny.canny(jnp.asarray(make_test_image()),
                                   jcanny.CannyConfig()))


def _assert_lines_equal(got: Lines, want) -> None:
    for name in Lines._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


SHT_CASES = {
    "lines_img": (_lines_img, dict(threshold=40, max_lines=8)),
    "lines_img_fine": (_lines_img, dict(threshold=20, max_lines=16, rho=0.7,
                                        theta_step_deg=0.5)),
    "lines_img_fraction": (_lines_img, dict(threshold=0.3, max_lines=8)),
    "dense": (_dense_map, dict(threshold=200, max_lines=8)),
    "golden": (_golden_edges, dict()),
    "golden_fraction": (_golden_edges, dict(threshold=0.25, max_lines=32)),
}


@pytest.mark.parametrize("case", list(SHT_CASES))
def test_hough_sht_exact(case):
    make, kw = SHT_CASES[case]
    img = make()
    jcfg = jhough.HoughShtConfig(**kw)
    want = jhough.hough_sht(jnp.asarray(img), jcfg)
    got = hough.hough_sht(torch.from_numpy(img), config_from_reference(jcfg))
    _assert_lines_equal(got, want)
    assert int(got.count()) == int(want.count()) > 0


def test_hough_sht_exact_past_58112_rho_bins():
    """A rho step so fine that a theta row (64,033 bins) is wider than a
    block's shared memory on the card, where the kernel tiles rho: on the
    CPU the port still equals the reference line for line."""
    img = np.zeros((40, 50), np.uint8)
    img[12, 4:46] = 255
    img[3:37, 21] = 255
    jcfg = jhough.HoughShtConfig(rho=0.002, threshold=20, max_lines=8,
                                 max_edge_points=256)
    want = jhough.hough_sht(jnp.asarray(img), jcfg)
    got = hough.hough_sht(torch.from_numpy(img), config_from_reference(jcfg))
    _assert_lines_equal(got, want)
    assert int(got.count()) == int(want.count()) > 0


def test_hough_sht_meets_golden():
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        gold = json.load(f)["hough_sht_summary"]
    img = torch.from_numpy(make_test_image())
    lines = hough.hough_sht(canny.canny(img, canny.CannyConfig()),
                            hough.HoughShtConfig())
    assert golden.lines_summary(lines) == gold


def test_hough_sht_empty():
    lines = hough.hough_sht(torch.zeros((32, 32), dtype=torch.uint8))
    assert int(lines.count()) == 0 and lines.rho.shape == (64,)


@pytest.mark.parametrize("with_strengths", [False, True])
def test_hough_sht_stats_truncation(with_strengths):
    img = _dense_map()
    strengths = (np.where(img > 0, 1.0, 0.0).astype(np.float32)
                 + np.linspace(0, 1, img.size, dtype=np.float32
                               ).reshape(img.shape))
    jcfg = jhough.HoughShtConfig(threshold=10, max_lines=4,
                                 max_edge_points=1024)
    js = jnp.asarray(strengths) if with_strengths else None
    ts = torch.from_numpy(strengths) if with_strengths else None
    want, wstats = jhough.hough_sht_stats(jnp.asarray(img), jcfg, js)
    got, stats = hough.hough_sht_stats(torch.from_numpy(img),
                                       config_from_reference(jcfg), ts)
    assert stats == wstats
    assert stats["truncated"] and stats["n_edges"] > 1024
    _assert_lines_equal(got, want)


def test_hough_sht_stats_no_truncation():
    img = _lines_img()
    _, stats = hough.hough_sht_stats(torch.from_numpy(img))
    assert stats == {"n_edges": 159, "capacity": 65536, "truncated": False}


def _kht_moved_points(img, gx, gy, cfg) -> int:
    """Edge points whose centre theta bin differs between XLA's arctan2 and
    torch.atan2 on the same structure tensor (built in numpy in the
    reference's f32 order)."""
    h, w = img.shape
    p_gx, p_gy = np.pad(gx, 1), np.pad(gy, 1)
    jxx = np.zeros_like(gx)
    jxy = np.zeros_like(gx)
    jyy = np.zeros_like(gx)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = p_gx[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            b = p_gy[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            jxx, jxy, jyy = jxx + a * a, jxy + a * b, jyy + b * b
    num, den = np.float32(2.0) * jxy, jxx - jyy
    step = np.float32(np.deg2rad(cfg.theta_step_deg))
    n_theta = int(np.round(np.pi / float(np.deg2rad(cfg.theta_step_deg))))
    bins = []
    for ang in (np.asarray(jnp.arctan2(jnp.asarray(num), jnp.asarray(den))),
                torch.atan2(torch.from_numpy(num), torch.from_numpy(den)
                            ).numpy()):
        ang = np.float32(0.5) * ang
        ang = np.where(ang < 0, ang + np.float32(np.pi), ang)
        bins.append(np.round(ang / step).astype(np.int64) % n_theta)
    return int((bins[0] != bins[1])[img > 0].sum())


KHT_CASES = {
    "lines_img": (_lines_img, dict(max_lines=8, threshold_ratio=0.05)),
    "golden": (_golden_edges, dict()),
    "golden_wide": (_golden_edges, dict(max_edge_points=2048, rho=0.7,
                                        theta_step_deg=1.0)),
}


@pytest.mark.parametrize("case", list(KHT_CASES))
def test_hough_kht_matches(case):
    make, kw = KHT_CASES[case]
    img = make()
    src = make_test_image() if case.startswith("golden") else img
    jgx, jgy = jedges.sobel_gradients(jnp.asarray(src))
    jcfg = jhough.HoughKhtConfig(**kw)
    want = jhough.hough_kht(jnp.asarray(img), jgx, jgy, jcfg)
    gx, gy = edges.sobel_gradients(torch.from_numpy(src))
    got = hough.hough_kht(torch.from_numpy(img), gx, gy,
                          config_from_reference(jcfg))
    moved = _kht_moved_points(img, gx.numpy(), gy.numpy(), jcfg)
    assert moved == 0, f"{moved} points moved their centre bin"
    _assert_lines_equal(got, want)
    assert int(got.count()) > 0


def test_hough_lines_to_cartesian():
    img = _golden_edges()
    want_lines = jhough.hough_sht(jnp.asarray(img))
    want = np.asarray(jhough.hough_lines_to_cartesian(want_lines, 480, 360))
    lines = result_from_numpy(Lines, want_lines)
    got = hough.hough_lines_to_cartesian(lines, 480, 360)
    assert got.shape == (64, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_lines_summary_copy_equals_original():
    rs = np.random.default_rng(0)
    lines = JLines(jnp.asarray(rs.normal(size=20).astype(np.float32) * 300),
                   jnp.asarray(rs.uniform(0, 3, 20).astype(np.float32)),
                   jnp.asarray(rs.integers(1, 900, 20).astype(np.float32)),
                   jnp.asarray(rs.random(20) < 0.6))
    assert golden.lines_summary(lines) == jgolden.lines_summary(lines)
    port = result_from_numpy(Lines, lines)
    assert golden.lines_summary(port) == jgolden.lines_summary(lines)


def test_lines_round_trip_and_count():
    rs = np.random.default_rng(1)
    d = {"rho": rs.normal(size=5).astype(np.float32),
         "theta": rs.random(5).astype(np.float32),
         "strength": rs.random(5).astype(np.float32),
         "valid": np.array([1, 0, 1, 1, 0], bool)}
    lines = result_from_numpy(Lines, d)
    assert lines.valid.dtype == torch.bool and int(lines.count()) == 3
    back = result_to_numpy(lines)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("cfg", [
    jhough.HoughShtConfig(rho=0.7, theta_step_deg=0.5, threshold=0.4,
                          max_lines=9, max_edge_points=777),
    jhough.HoughKhtConfig(rho=1.5, theta_step_deg=1.0, threshold_ratio=0.1,
                          max_lines=5, min_votes=12.0, max_edge_points=99),
])
def test_hough_configs_convert(cfg):
    port = config_from_reference(cfg)
    assert type(port).__name__ == type(cfg).__name__
    assert type(port).__module__ == "compv_tpu_torch.features.hough"
    for name, value in vars(cfg).items():
        assert getattr(port, name) == value
