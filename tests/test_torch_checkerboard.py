"""Port parity for checkerboard corner detection: ``find_chessboard_corners``
and ``line_intersections`` against ``compv_tpu.calib.checkerboard`` on the
same rendered boards (CPU; the Hough accumulator runs K4's twin).

Tolerances: ``valid`` equal to the reference's; corners within 1e-3 px of
the reference's (they are equal on these boards: the Canny map and the
Hough lines are bit-equal, and the intersections use ``torch.cos`` /
``torch.sin``, which may differ from XLA's by an ulp) and within 3 px of
the rendered truth; intersections within 1e-3 px of the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.calib import checkerboard as jcb
from compv_tpu_torch.calib import checkerboard as cb
from compv_tpu_torch.features.canny import CannyConfig
from compv_tpu_torch.interop import (config_from_reference, result_from_numpy,
                                     result_to_numpy)
from tests.test_checkerboard import render_board

BOARDS = {
    "axis_aligned": dict(),
    "rotated_12": dict(angle_deg=12.0),
    "large_rotated_12": dict(square=80, margin=80, angle_deg=12.0),
}
CONFIGS = {"votes_60": dict(hough_threshold=60), "default": dict()}


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("board", list(BOARDS))
def test_find_chessboard_corners_matches(board, cfg_name):
    img, truth = render_board(**BOARDS[board])
    jcfg = jcb.CheckerboardConfig(**CONFIGS[cfg_name])
    want = jcb.find_chessboard_corners(jnp.asarray(img), jcfg)
    got = cb.find_chessboard_corners(torch.from_numpy(img),
                                     config_from_reference(jcfg))
    assert bool(got.valid) == bool(want.valid) is True
    corners = got.corners.numpy()
    assert corners.shape == (48, 2) and corners.dtype == np.float32
    np.testing.assert_allclose(corners, np.asarray(want.corners), rtol=0,
                               atol=1e-3)
    assert np.abs(corners - truth).max() < 3.0
    for fam in ("h_lines", "v_lines"):
        g, w = getattr(got, fam), getattr(want, fam)
        np.testing.assert_allclose(g.rho.numpy(), np.asarray(w.rho), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g.theta.numpy(), np.asarray(w.theta),
                                   rtol=0, atol=1e-6)
        assert bool(g.valid.all())


def test_noise_is_not_a_board():
    img = np.random.default_rng(0).integers(0, 255, (200, 200), dtype=np.uint8)
    want = jcb.find_chessboard_corners(jnp.asarray(img))
    got = cb.find_chessboard_corners(torch.from_numpy(img))
    assert bool(got.valid) == bool(want.valid) is False


def test_line_intersections_axis_aligned():
    x, y = cb.line_intersections(torch.tensor(20.0), torch.tensor(np.pi / 2),
                                 torch.tensor(40.0), torch.tensor(0.0))
    assert abs(float(x) - 40) < 1e-5 and abs(float(y) - 20) < 1e-5


def test_line_intersections_match_reference():
    rs = np.random.default_rng(2)
    r1 = rs.uniform(-500, 500, (6, 1)).astype(np.float32)
    t1 = rs.uniform(1.2, 1.9, (6, 1)).astype(np.float32)
    r2 = rs.uniform(-500, 500, (1, 8)).astype(np.float32)
    t2 = rs.uniform(-0.3, 0.3, (1, 8)).astype(np.float32)
    wx, wy = jcb.line_intersections(*(jnp.asarray(a) for a in (r1, t1, r2,
                                                                t2)))
    x, y = cb.line_intersections(*(torch.from_numpy(a) for a in (r1, t1, r2,
                                                                  t2)))
    assert x.shape == (6, 8)
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), rtol=0, atol=1e-3)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=0, atol=1e-3)
    # each point lies on both of its lines
    for r, t in ((r1, t1), (r2, t2)):
        on = x.numpy() * np.cos(t) + y.numpy() * np.sin(t) - r
        assert np.abs(on).max() < 1e-2


def test_parallel_lines_do_not_divide_by_zero():
    x, y = cb.line_intersections(torch.tensor(10.0), torch.tensor(0.5),
                                 torch.tensor(30.0), torch.tensor(0.5))
    assert torch.isfinite(x) and torch.isfinite(y)


def test_checkerboard_config_round_trip():
    jcfg = jcb.CheckerboardConfig(rows=5, cols=7, hough_threshold=0.4,
                                  merge_rho=8.0, grid_tolerance=2.5)
    port = config_from_reference(jcfg)
    assert isinstance(port, cb.CheckerboardConfig)
    assert isinstance(port.canny, CannyConfig)
    assert port == cb.CheckerboardConfig(5, 7, CannyConfig(40.0, 100.0), 0.4,
                                         8.0, 2.5)


def test_checkerboard_result_round_trip():
    img, _ = render_board()
    want = jcb.find_chessboard_corners(jnp.asarray(img))
    res = result_from_numpy(cb.CheckerboardResult, want)
    assert isinstance(res.h_lines, cb.Lines) and res.valid.dtype == torch.bool
    back = result_to_numpy(res)
    np.testing.assert_array_equal(back["corners"], np.asarray(want.corners))
    np.testing.assert_array_equal(back["h_lines"]["rho"],
                                  np.asarray(want.h_lines.rho))
    assert bool(back["valid"]) == bool(want.valid)
