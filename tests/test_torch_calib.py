"""Port parity of camera calibration: ``calib/lm.py``, ``calib/utils.py``
and ``calib/camera.py`` against ``compv_tpu`` on the same numpy inputs
(CPU), with the reference tests' own bars (``tests/test_calibration.py``,
``tests/test_f32_conditioning.py:172-205``, ``tests/test_checkerboard.py``).

Tolerances, each with its reason:
* K, the distortion and the final RMS error of ``calibrate_camera``: 1e-3
  relative to the reference's (float32 DLT, eigh, SVD and 40 LM steps of
  another LAPACK and summation order; measured about 1e-5 on K); the
  closed-form RMS before LM: 5e-3 relative (it is computed from the
  closed-form K alone, the smallest eigenvector of a 6 x 6 V^T V with
  entries near 1e6 in float32, before LM pulls both packages to one
  minimum; measured 1.2e-3);
* LM parameters: 1e-4 absolute on problems that converge to an exact
  minimum;
* Zhang's closed form and the extrinsics: 1e-3 relative (eigh of a 6 x 6
  V^T V whose entries reach 1e6, in f32);
* projections, undistortion maps and undistorted points: 1e-3 px (the
  same f32 formulas; rodrigues' sin and cos of two math libraries);
* ``undistort_image``: u8 pixels within 1 (a sample position an ulp apart
  rounds the other way).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.calib import camera as jcam
from compv_tpu.calib import lm as jlm
from compv_tpu.calib import utils as jutil
from compv_tpu.calib.homography import compute_homography_dlt as jdlt
from compv_tpu_torch.calib import camera as tcam
from compv_tpu_torch.calib import lm as tlm
from compv_tpu_torch.calib import utils as tutil
from compv_tpu_torch.calib.homography import compute_homography_dlt as tdlt
from compv_tpu_torch.interop import config_from_reference, result_from_numpy
from compv_tpu_torch.math.rotation import rodrigues_to_matrix

K_TRUE = np.array([[800.0, 0.0, 320.0], [0.0, 810.0, 240.0], [0.0, 0.0, 1.0]])
DIST_TRUE = np.array([-0.20, 0.05, 0.0, 0.0])
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on a few cores; with a
    PyTorch thread per core in each of them, small ops wait on threads the
    other processes hold. One thread per process for this file, restored
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _project(obj, k, dist, rvec, tvec):
    return tutil.project_points_dist(_t(obj), _t(k), _t(dist), _t(rvec),
                                     _t(tvec)).numpy()


def synth_views(n_views=5, rows=6, cols=8, square=30.0, noise=0.0, seed=0,
                dist=DIST_TRUE, k=K_TRUE):
    """The views of tests/test_calibration.py:26-44, projected by the
    port."""
    rs = np.random.default_rng(seed)
    obj = tcam.checkerboard_object_points(rows, cols, square, CPU).numpy()
    img_pts, rvecs, tvecs = [], [], []
    for i in range(n_views):
        rvec = np.array([0.12, -0.1, 0.05]) * (i - 2) + rs.normal(0, 0.03, 3)
        tvec = np.array([-cols * square / 2, -rows * square / 2, 900.0]
                        ) + rs.normal(0, 12.0, 3)
        proj = _project(obj, k, dist, rvec, tvec)
        img_pts.append(proj + rs.normal(0, noise, proj.shape))
        rvecs.append(rvec)
        tvecs.append(tvec)
    return obj, np.stack(img_pts), np.stack(rvecs), np.stack(tvecs)


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-6), (
        got, want)


# ---------------------------------------------------------------- LM

def test_lm_rosenbrock():
    def tres(x):
        # tensor constants: a 0-d tensor and a Python float give a float64
        # tangent under forward-mode AD, which the port's LM refuses
        ten, one = x.new_tensor(10.0), x.new_tensor(1.0)
        return torch.stack([ten * (x[1] - x[0] ** 2), one - x[0]])

    def jres(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    cfg = jlm.LMConfig(iterations=60)
    got = tlm.levenberg_marquardt(tres, torch.tensor([-1.2, 1.0]),
                                  config_from_reference(cfg))
    want = jlm.levenberg_marquardt(jres, jnp.asarray([-1.2, 1.0]), cfg)
    np.testing.assert_allclose(got.params.numpy(), [1.0, 1.0], atol=1e-3)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               atol=1e-4)
    assert float(got.cost) < 1e-8
    assert float(got.initial_cost) == pytest.approx(
        float(want.initial_cost), rel=1e-6)
    back = result_from_numpy(tlm.LMResult, want)
    assert back.params.dtype == torch.float32


def test_lm_refuses_a_float64_jacobian():
    """The Jacobian is not cast to the parameters' dtype: a residual whose
    tangent leaks into float64 is refused, not hidden."""
    with pytest.raises(TypeError, match="float64"):
        tlm.levenberg_marquardt(
            lambda x: torch.stack([2.0 * x[0] - 1.0, x[1]]),
            torch.tensor([0.0, 0.0]))


@pytest.mark.parametrize("skew,tangential",
                         [(False, False), (True, True)])
def test_calibration_residual_jacobian_is_float32(skew, tangential):
    """LM's residual in ``calibrate_camera`` keeps float32 tangents under
    ``torch.func.jacfwd`` (no Python float meets a 0-d dual tensor), and so
    does ``distort_normalized`` on 0-d coordinates."""
    obj, img, rvecs, tvecs = synth_views(n_views=3)
    cfg = tcam.CalibrationConfig(with_skew=skew, with_tangential=tangential)
    head = [800.0, 810.0, 320.0, 240.0] + [0.0] * skew + [-0.2, 0.05] \
        + [0.001, -0.002] * tangential
    x = torch.cat([_t(head), _t(rvecs).reshape(-1), _t(tvecs).reshape(-1)])
    j = torch.func.jacfwd(lambda v: tcam._calibration_residual(
        v, _t(obj), _t(img), cfg))(x)
    assert j.dtype == torch.float32 and j.shape == (img.size, x.numel())
    assert torch.isfinite(j).all()
    jd = torch.func.jacfwd(lambda v: torch.stack(tutil.distort_normalized(
        v[0], v[1], v[2:])))(_t([0.1, -0.2, -0.2, 0.05, 0.001, -0.002]))
    assert jd.dtype == torch.float32


def test_lm_never_worse():
    res = tlm.levenberg_marquardt(lambda x: x * x - 2.0,
                                  torch.tensor([5.0, -3.0]))
    assert float(res.cost) <= float(res.initial_cost)
    assert res.params.dtype == torch.float32


# ---------------------------------------------------------------- utils

def test_project_points_batched_equals_reference():
    obj, _, rvecs, tvecs = synth_views()
    got = tutil.project_points_dist(_t(obj), _t(K_TRUE), _t(DIST_TRUE),
                                    _t(rvecs), _t(tvecs)).numpy()
    for i in range(len(rvecs)):
        want = np.asarray(jutil.project_points_dist(
            jnp.asarray(obj), jnp.asarray(K_TRUE, jnp.float32),
            jnp.asarray(DIST_TRUE, jnp.float32),
            jnp.asarray(rvecs[i], jnp.float32),
            jnp.asarray(tvecs[i], jnp.float32)))
        np.testing.assert_allclose(got[i], want, atol=1e-3)
        np.testing.assert_allclose(
            _project(obj, K_TRUE, DIST_TRUE, rvecs[i], tvecs[i]), got[i],
            atol=1e-4)


def test_reproj_error_rms():
    rs = np.random.default_rng(2)
    a = rs.normal(0, 50, (64, 2)).astype(np.float32)
    b = a + rs.normal(0, 1, (64, 2)).astype(np.float32)
    m = rs.random(64) < 0.5
    for mask in (None, m):
        want = float(jutil.reproj_error_rms(
            jnp.asarray(a), jnp.asarray(b),
            None if mask is None else jnp.asarray(mask)))
        got = float(tutil.reproj_error_rms(
            _t(a), _t(b), None if mask is None else _t(mask, torch.bool)))
        assert got == pytest.approx(want, rel=1e-6)


def test_undistort_points_round_trip_and_parity():
    rs = np.random.default_rng(1)
    pts = rs.uniform(50, 550, (100, 2)).astype(np.float32)
    k, d = _t(K_TRUE), _t(DIST_TRUE)
    und = tutil.undistort_points(_t(pts), k, d)
    want = np.asarray(jutil.undistort_points(
        jnp.asarray(pts), jnp.asarray(K_TRUE, jnp.float32),
        jnp.asarray(DIST_TRUE, jnp.float32)))
    np.testing.assert_allclose(und.numpy(), want, atol=1e-3)
    xn = (und[:, 0] - 320) / 800
    yn = (und[:, 1] - 240) / 810
    xd, yd = tutil.distort_normalized(xn, yn, d)
    back = torch.stack([xd * 800 + 320, yd * 810 + 240], 1).numpy()
    np.testing.assert_allclose(back, pts, atol=0.05)


def test_undistort_map_and_image():
    rs = np.random.default_rng(3)
    img = rs.integers(0, 256, (60, 80), dtype=np.uint8)
    k = np.array([[70.0, 0.5, 41.0], [0.0, 72.0, 29.0], [0, 0, 1]])
    d = np.array([-0.2, 0.05, 0.001, -0.002])
    for got, want in zip(
            tutil.build_undistort_map(_t(k), _t(d), 60, 80),
            jutil.build_undistort_map(jnp.asarray(k, jnp.float32),
                                      jnp.asarray(d, jnp.float32), 60, 80)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    got = tutil.undistort_image(torch.from_numpy(img), _t(k), _t(d)).numpy()
    want = np.asarray(jutil.undistort_image(jnp.asarray(img),
                                            jnp.asarray(k, jnp.float32),
                                            jnp.asarray(d, jnp.float32)))
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------- camera

def test_checkerboard_object_points():
    want = np.asarray(jcam.checkerboard_object_points(6, 8, 30.0))
    got = tcam.checkerboard_object_points(6, 8, 30.0, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tcam.checkerboard_object_points(6, 8, 30.0)


def test_zhang_closed_form():
    obj, img_pts, rvecs, tvecs = synth_views(dist=np.zeros(4))
    hs_t = torch.stack([tdlt(_t(obj[:, :2]), _t(p)) for p in img_pts])
    hs_j = jnp.stack([jdlt(jnp.asarray(obj[:, :2]), jnp.asarray(p, jnp.float32))
                      for p in img_pts])
    k = tcam.intrinsics_from_homographies(hs_t).numpy()
    _close_rel(k, np.asarray(jcam.intrinsics_from_homographies(hs_j)), 1e-3)
    assert abs(k[0, 0] - 800) / 800 < 0.03 and abs(k[1, 1] - 810) / 810 < 0.03
    assert abs(k[0, 2] - 320) < 15 and abs(k[1, 2] - 240) < 15
    # extrinsics, one plane and batched
    r, t = tcam.extrinsics_from_homography(hs_t[2], _t(K_TRUE))
    rj, tj = jcam.extrinsics_from_homography(hs_j[2],
                                             jnp.asarray(K_TRUE, jnp.float32))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-4)
    _close_rel(t.numpy(), np.asarray(tj), 1e-3)
    np.testing.assert_allclose(r.numpy(), rodrigues_to_matrix(
        _t(rvecs[2])).numpy(), atol=0.02)
    np.testing.assert_allclose(t.numpy(), tvecs[2], rtol=0.03)
    rb, tb = tcam.extrinsics_from_homography(hs_t, _t(K_TRUE))
    np.testing.assert_allclose(rb[2].numpy(), r.numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.linalg.det(rb).numpy(), 1.0, atol=1e-5)


def _calibrate_both(obj, img_pts, cfg=None):
    jcfg = cfg if cfg is not None else jcam.CalibrationConfig()
    want = jcam.calibrate_camera(jnp.asarray(obj, jnp.float32),
                                 jnp.asarray(img_pts, jnp.float32), jcfg)
    got = tcam.calibrate_camera(_t(obj), _t(img_pts),
                                config_from_reference(jcfg))
    return got, want


def test_calibrate_camera_equals_reference():
    """tests/test_calibration.py's full calibration (noise 0.1 px), both
    packages on the same corners."""
    obj, img_pts, _, _ = synth_views(noise=0.1)
    got, want = _calibrate_both(obj, img_pts)
    k, d = got.k.numpy(), got.dist.numpy()
    _close_rel(k, np.asarray(want.k), 1e-3)
    np.testing.assert_allclose(d, np.asarray(want.dist), atol=5e-3)
    assert float(got.rms_initial) == pytest.approx(float(want.rms_initial),
                                                   rel=5e-3)
    assert float(got.rms) == pytest.approx(float(want.rms), rel=1e-3)
    np.testing.assert_allclose(got.rvecs.numpy(), np.asarray(want.rvecs),
                               atol=1e-3)
    _close_rel(got.tvecs.numpy(), np.asarray(want.tvecs), 1e-3)
    # the reference's own bars
    assert abs(k[0, 0] - 800) / 800 < 0.01
    assert abs(k[1, 1] - 810) / 810 < 0.01
    assert abs(k[0, 2] - 320) < 4 and abs(k[1, 2] - 240) < 4
    assert abs(d[0] - (-0.20)) < 0.02 and abs(d[1] - 0.05) < 0.05
    assert float(got.rms) < 0.5
    assert float(got.rms) <= float(got.rms_initial) + 1e-6
    back = result_from_numpy(tcam.CalibrationResult, want)
    _close_rel(back.k.numpy(), k, 1e-3)


@pytest.mark.parametrize("focal", [250.0, 800.0, 2500.0])
def test_zhang_recovers_focal_f32(focal):
    """tests/test_f32_conditioning.py:172-205: fx and fy within 1 % across
    a 10x focal range in float32, and K within 1e-3 of the reference's."""
    rs = np.random.default_rng(int(focal))
    k_true = np.array([[focal, 0.0, 320.0], [0.0, focal * 1.01, 240.0],
                       [0.0, 0.0, 1.0]])
    obj = tcam.checkerboard_object_points(6, 8, 30.0, CPU).numpy()
    z0 = 900.0 * focal / 800.0
    img_pts = []
    for i in range(6):
        rvec = np.array([0.14, -0.12, 0.06]) * (i - 2.5) \
            + rs.normal(0, 0.03, 3)
        tvec = np.array([-120.0, -90.0, z0]) + rs.normal(0, 10.0, 3)
        img_pts.append(_project(obj, k_true, np.zeros(4), rvec, tvec))
    got, want = _calibrate_both(obj, np.stack(img_pts))
    k = got.k.numpy()
    assert abs(k[0, 0] - focal) / focal < 0.01, k
    assert abs(k[1, 1] - focal * 1.01) / (focal * 1.01) < 0.01, k
    _close_rel(k, np.asarray(want.k), 1e-3)


def test_calibrate_tangential_and_skew():
    """The optional parameters (p1, p2, skew) enter LM as in the
    reference."""
    obj, img_pts, _, _ = synth_views(noise=0.1, seed=3,
                                     dist=np.array([-0.2, 0.05, 1e-3, -2e-3]))
    cfg = jcam.CalibrationConfig(with_tangential=True, with_skew=True,
                                 lm_iterations=20)
    got, want = _calibrate_both(obj, img_pts, cfg)
    _close_rel(got.k.numpy(), np.asarray(want.k), 1e-3)
    np.testing.assert_allclose(got.dist.numpy(), np.asarray(want.dist),
                               atol=5e-3)
    assert float(got.rms) <= float(got.rms_initial) + 1e-6
    assert float(got.rms) == pytest.approx(float(want.rms), rel=1e-3)


def render_board(rows=6, cols=8, square=40, margin=60):
    """Axis-aligned board and its inner corners: a copy of
    tests/test_checkerboard.py:12-42 at angle 0."""
    h = (rows + 1) * square + 2 * margin
    w = (cols + 1) * square + 2 * margin
    yy, xx = np.mgrid[0:h, 0:w]
    ix = np.floor((xx - margin) / square).astype(int)
    iy = np.floor((yy - margin) / square).astype(int)
    board = (((ix + iy) % 2 == 0) & (ix >= 0) & (ix <= cols) & (iy >= 0)
             & (iy <= rows))
    corners = [[margin + c * square, margin + r * square]
               for r in range(1, rows + 1) for c in range(1, cols + 1)]
    return np.where(board, 230, 30).astype(np.uint8), np.array(corners)


@pytest.mark.slow
def test_image_to_calibration():
    """tests/test_checkerboard.py:83-133 in the port: rendered boards warped
    into 4 views of known K -> corners -> calibrate, at the reference's
    bars."""
    from compv_tpu_torch.calib.checkerboard import (CheckerboardConfig,
                                                    find_chessboard_corners)
    from compv_tpu_torch.image.remap import warp_perspective

    rows, cols, square = 6, 8, 40.0
    k_true = np.array([[700.0, 0, 330.0], [0, 700.0, 250.0], [0, 0, 1.0]])
    obj = tcam.checkerboard_object_points(rows, cols, square, CPU)
    base_img, base_corners = render_board(rows, cols, int(square))
    img_pts = []
    for i in range(4):
        rvec = np.array([0.25, -0.2, 0.1]) * (i - 1.5)
        tvec = np.array([-cols * square / 2, -rows * square / 2, 1400.0])
        proj = _project(obj.numpy(), k_true, np.zeros(4), rvec, tvec)
        h = tdlt(_t(base_corners), _t(proj))
        view = warp_perspective(torch.from_numpy(base_img),
                                torch.linalg.inv(h), 500, 660, fill=128.0)
        res = find_chessboard_corners(view, CheckerboardConfig(
            rows=rows, cols=cols, hough_threshold=50))
        if bool(res.valid):
            img_pts.append(res.corners)
    assert len(img_pts) >= 3, "not enough boards detected"
    cres = tcam.calibrate_camera(obj, torch.stack(img_pts))
    k = cres.k.numpy()
    assert abs(k[0, 0] - 700) / 700 < 0.15
    assert abs(k[1, 1] - 700) / 700 < 0.15
    assert float(cres.rms) < 5.0
    assert float(cres.rms) <= float(cres.rms_initial) + 1e-6


def test_calib_package_exports():
    calib = importlib.import_module("compv_tpu_torch.calib")
    ref = importlib.import_module("compv_tpu.calib")
    for name in ("RansacConfig", "RansacResult", "ransac", "CalibrationConfig",
                 "CalibrationResult", "calibrate_camera",
                 "checkerboard_object_points", "LMConfig", "LMResult",
                 "levenberg_marquardt", "project_points_dist",
                 "reproj_error_rms", "build_undistort_map", "undistort_image",
                 "undistort_points", "distort_normalized"):
        assert hasattr(ref, name) and hasattr(calib, name), name
