"""The port's edge_lines and camera_calibration programs
(``examples_torch/``) against the reference's (``examples/``), run in the
same test.

The reference program runs in a subprocess (JAX on the CPU, its
``out_path`` patched to a temporary directory by
``scripts/examples_reference.py``, so ``examples/out/`` is never written);
the port's runs in the test process with ``--device cpu``. Both print the
same lines, parsed by ``examples_reference.parse``, and the reference's
calls are recorded in full precision beside what it prints. Tolerances:

* edge_lines: everything exact — the Canny edge count, the SHT lines as
  printed and as returned (rho, theta, votes, valid), the KHT count and
  lines, and both written PNGs pixel for pixel;
* camera_calibration: the detected flags exact (the reference misses view
  2, and so must the port); each view's DLT homography within 1e-4 of the
  reference's, relative to its largest entry; K within 1e-3 relative and
  dist within 5e-3, the RMS within 1e-3 relative and the RMS before LM
  within 5e-3 (``tests/test_torch_calib.py``'s bars for
  ``calibrate_camera``), and the printed values within the same bars plus
  one unit of the last printed digit; the images: the
  port's warp of view 2 through the reference's H, and its undistortion
  through the reference's K and dist, pixel for pixel equal to the
  reference's files; the program's own files, whose H and K differ from the
  reference's within the bars above, differ in at most 0.2 % of the view's
  pixels (border pixels that flip between the fill and the board: 240 of
  330,000 on the CPU) and at most 3 % of the undistorted image's (3,209 of
  192,000 on the CPU).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "examples_reference", os.path.join(_ROOT, "scripts",
                                       "examples_reference.py"))
er = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(er)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's torch work on one thread here and in the ranks it spawns
    (``OMP_NUM_THREADS``, read by a rank's torch at import), restored
    after: beside the other test workers a many-threaded CPU run stalls on
    its thread pool's barriers (minutes for seconds of work)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _both(name, tmp_path_factory):
    ref_dir = str(tmp_path_factory.mktemp(f"{name}_ref"))
    port_dir = str(tmp_path_factory.mktemp(f"{name}_port"))
    ref_text, ref_calls = er.run_subprocess(name, ref_dir)
    port_text, port_calls = er.run_port(name, ["--device", "cpu"], port_dir)
    return {"ref": (ref_text, ref_calls, ref_dir),
            "port": (port_text, er.plain(port_calls), port_dir)}


@pytest.fixture(scope="module")
def edge(tmp_path_factory):
    return _both("edge_lines", tmp_path_factory)


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    return _both("camera_calibration", tmp_path_factory)


# ------------------------------------------------------------ edge_lines

def test_edge_lines_prints_the_reference_lines(edge):
    want = er.parse("edge_lines", edge["ref"][0])
    got = er.parse("edge_lines", edge["port"][0])
    assert want["canny_pixels"] == 488 and want["sht_count"] == 4
    assert got == want


@pytest.mark.parametrize("call", ["hough_sht", "hough_kht"])
def test_edge_lines_lines_equal_the_reference(edge, call):
    want, got = edge["ref"][1][call][0], edge["port"][1][call][0]
    for field in ("rho", "theta", "strength", "valid"):
        np.testing.assert_array_equal(np.asarray(got[field]),
                                      np.asarray(want[field]), err_msg=field)


@pytest.mark.parametrize("name", ["edges.png", "hough_lines.png"])
def test_edge_lines_images_equal_the_reference(edge, name):
    want = _png(os.path.join(edge["ref"][2], name))
    got = _png(os.path.join(edge["port"][2], name))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- camera_calibration

def test_calibration_prints_the_reference_lines(calib):
    want = er.parse("camera_calibration", calib["ref"][0])
    got = er.parse("camera_calibration", calib["port"][0])
    assert want["detected"] == [True, True, False, True, True]
    assert got["detected"] == want["detected"]
    # the bars below on the printed values, plus one unit of the last
    # printed digit of each side's rounding
    scale = max(abs(want[key]) for key in ("fx", "fy", "cx", "cy"))
    for key in ("fx", "fy", "cx", "cy"):
        assert abs(got[key] - want[key]) <= 1e-3 * scale + 0.1, key
    np.testing.assert_allclose(got["dist"], want["dist"], atol=5e-3 + 1e-4)
    assert abs(got["rms"] - want["rms"]) <= 1e-3 * want["rms"] + 1e-3
    assert abs(got["rms_initial"] - want["rms_initial"]) <= \
        5e-3 * want["rms_initial"] + 1e-3
    assert got["wrote"] == want["wrote"]


def test_calibration_homographies_and_corners(calib):
    ref, port = calib["ref"][1], calib["port"][1]
    for want, got in zip(ref["compute_homography_dlt"],
                         port["compute_homography_dlt"], strict=True):
        want, got = np.asarray(want), np.asarray(got)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    dets = list(zip(ref["find_chessboard_corners"],
                    port["find_chessboard_corners"], strict=True))
    assert [g["valid"] for _, g in dets] == [w["valid"] for w, _ in dets]
    for want, got in dets:
        if want["valid"]:
            np.testing.assert_allclose(got["corners"], want["corners"],
                                       atol=0.05)


def test_calibration_result_within_the_reference_bars(calib):
    want = calib["ref"][1]["calibrate_camera"][0]
    got = calib["port"][1]["calibrate_camera"][0]
    k, wk = np.asarray(got["k"]), np.asarray(want["k"])
    assert np.abs(k - wk).max() <= 1e-3 * np.abs(wk).max()
    np.testing.assert_allclose(got["dist"], want["dist"], atol=5e-3)
    assert got["rms"] == pytest.approx(want["rms"], rel=1e-3)
    assert got["rms_initial"] == pytest.approx(want["rms_initial"], rel=5e-3)


def test_calibration_images_against_the_reference(calib):
    """The image operations are exact on the reference's parameters; the
    program's own files differ only as far as its H and K do."""
    from compv_tpu_torch.calib.utils import undistort_image
    from compv_tpu_torch.image import warp_perspective

    mod = er.load_port("camera_calibration")
    base, _ = mod.render_board(6, 8, 40)
    ref, ref_dir, port_dir = calib["ref"][1], calib["ref"][2], \
        calib["port"][2]
    h = np.asarray(ref["compute_homography_dlt"][2], np.float32)
    view = warp_perspective(torch.from_numpy(base),
                            torch.from_numpy(np.linalg.inv(h)), 500, 660,
                            fill=128.0).numpy()
    want_view = _png(os.path.join(ref_dir, "calibration_view.png"))
    np.testing.assert_array_equal(view, want_view)
    res = ref["calibrate_camera"][0]
    und = undistort_image(torch.from_numpy(base),
                          torch.tensor(res["k"], dtype=torch.float32),
                          torch.tensor(res["dist"], dtype=torch.float32))
    want_und = _png(os.path.join(ref_dir, "calibration_undistorted.png"))
    np.testing.assert_array_equal(und.numpy(), want_und)

    got_view = _png(os.path.join(port_dir, "calibration_view.png"))
    got_und = _png(os.path.join(port_dir, "calibration_undistorted.png"))
    assert got_view.shape == want_view.shape
    assert got_und.shape == want_und.shape
    assert (got_view != want_view).sum() <= 0.002 * want_view.size
    assert (got_und != want_und).sum() <= 0.03 * want_und.size


def test_calibration_k2_is_ill_conditioned(calib):
    """Why the card's run holds k2 by 1 % (``chip_smoke.K2_REL``) and not
    by the 5e-3 above: on the program's own corners, 1e-4 px of noise
    (seeded) moves k2 by more than 5e-3, while K and k1 stay within their
    bars."""
    from compv_tpu_torch.calib.camera import (calibrate_camera,
                                              checkerboard_object_points)

    port = calib["port"][1]
    pts = np.stack([np.asarray(d["corners"], np.float32)
                    for d in port["find_chessboard_corners"] if d["valid"]])
    obj = checkerboard_object_points(6, 8, 40.0, device="cpu")
    base = calibrate_camera(obj, torch.from_numpy(pts))
    rng = np.random.default_rng(0)
    k2 = []
    for _ in range(5):
        noisy = pts + rng.normal(0.0, 1e-4, pts.shape).astype(np.float32)
        res = calibrate_camera(obj, torch.from_numpy(noisy))
        k = res.k.numpy()
        assert np.abs(k - base.k.numpy()).max() <= 1e-3 * np.abs(k).max()
        assert abs(float(res.dist[0] - base.dist[0])) <= 5e-3
        k2.append(float(res.dist[1]))
    spread = max(abs(v - float(base.dist[1])) for v in k2)
    assert 5e-3 < spread <= 0.01 * abs(float(base.dist[1]))


# ------------------------------------------------------ no CPU fallback

@pytest.mark.parametrize("name", ["edge_lines", "camera_calibration"])
def test_program_without_device_needs_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the program would run on it")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        er.run_port(name, [], str(tmp_path))
    assert os.listdir(tmp_path) == []

