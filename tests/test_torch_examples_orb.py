"""The port's object_recognition, planar_tracking and live_demo programs
(``examples_torch/``) against the reference's (``examples/``), run in the
same test, and the port's ``common.py`` against the reference's.

The reference program runs in a subprocess (JAX on the CPU, its outputs in
a temporary directory: ``scripts/examples_reference.py``); the port's runs
in the test process with ``--device cpu``. The ORB level pixels differ from the
reference's by design (its jitted pipeline rounds a few bilinear pixels
otherwise than its own ``scale_bilinear``), so counts that come from
matching are held by ``tests/test_torch_frontend.py``'s bars:

* object_recognition: keypoint counts equal, matches within 2 % and
  inliers within 3 % (the first pair, and each of the 10 animation
  frames'), the recovered H within 0.05 px of the reference's over a grid
  of the 240x320 image (both printed Hs within that plus the printed
  rounding); the matches PNG pixel for pixel equal; each GIF frame (its
  outline drawn through the frame's H, its inlier count as text) differs
  in at most 0.1 % of its pixels (3 pixels of frame 0 on the CPU, 0 of the
  others);
* planar_tracking: the tracked flags exact; each frame's inliers within
  3 %; each chained H within 0.05 px of the reference's over the image's
  grid; the ATE within 0.05 px;
* live_demo: both programs serve a free port and stream 3 frames
  (``--max-frames``: the reference's first frame compiles its ORB
  pipeline, which on a loaded host can outlast a 2 s stream); the port's
  last frame equals the reference's drawing (ORB,
  ``draw_keypoints``, ``draw_text``, computed here by ``compv_tpu``) of the
  same camera frame pixel for pixel (the synthetic checkerboard's
  keypoints and angles come out equal at all three levels).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

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


def _frames(path) -> list:
    return [np.asarray(f.convert("RGB"))
            for f in ImageSequence.Iterator(Image.open(path))]


def _grid(h, w, step=20):
    gy, gx = np.mgrid[step:h - step + 1:step,
                      step:w - step + 1:step].astype(np.float64)
    return np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])


def _projection_gap(h1, h2, p) -> float:
    def project(h):
        q = np.asarray(h, np.float64).reshape(3, 3) @ p
        return q[:2] / q[2]
    return float(np.abs(project(h1) - project(h2)).max())


def _both(name, tmp_path_factory, args=(), max_frames=None):
    ref_dir = str(tmp_path_factory.mktemp(f"{name}_ref"))
    port_dir = str(tmp_path_factory.mktemp(f"{name}_port"))
    ref_text, ref_calls = er.run_subprocess(name, ref_dir, args,
                                            max_frames=max_frames)
    port_text, port_calls = er.run_port(name, ["--device", "cpu", *args],
                                        port_dir, max_frames=max_frames)
    return {"ref": (ref_text, ref_calls, ref_dir),
            "port": (port_text, port_calls, port_dir)}


@pytest.fixture(scope="module")
def objrec(tmp_path_factory):
    run = _both("object_recognition", tmp_path_factory)
    run["port"] = run["port"][:1] + (er.plain(run["port"][1]),) \
        + run["port"][2:]
    return run


@pytest.fixture(scope="module")
def planar(tmp_path_factory):
    run = _both("planar_tracking", tmp_path_factory)
    run["port"] = run["port"][:1] + (er.plain(run["port"][1]),) \
        + run["port"][2:]
    return run


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    return _both("live_demo", tmp_path_factory,
                 ("--seconds", "2", "--port", "0"), max_frames=LIVE_FRAMES)


# live_demo's stream ends after this many frames (not after its --seconds:
# the reference's first frame compiles its ORB pipeline, which on a loaded
# host outlasts a short stream)
LIVE_FRAMES = 3


def _close_count(got: int, want: int, rel: float) -> bool:
    return abs(got - want) <= rel * want


# ---------------------------------------------------- object_recognition

def test_object_recognition_prints_the_reference_lines(objrec):
    want = er.parse("object_recognition", objrec["ref"][0])
    got = er.parse("object_recognition", objrec["port"][0])
    assert (want["kp1"], want["kp2"]) == (512, 512) and want["matches"] > 100
    assert (got["kp1"], got["kp2"]) == (want["kp1"], want["kp2"])
    assert _close_count(got["matches"], want["matches"], 0.02)
    assert _close_count(got["inliers"], want["inliers"], 0.03)
    assert got["h_true"] == want["h_true"]
    # printed to 4 decimals: 0.05 px plus the rounding's own reach
    p = _grid(240, 320)
    slack = 5e-5 * np.abs(p).sum(axis=0).max() * 2
    assert _projection_gap(got["h"], want["h"], p) <= 0.05 + slack
    assert got["wrote"] == want["wrote"] == [
        "object_recognition_matches.png", "object_recognition.gif"]


def test_object_recognition_pairs_within_the_frontend_bars(objrec):
    want = objrec["ref"][1]["match_pair"]
    got = objrec["port"][1]["match_pair"]
    assert len(got) == len(want) == 11
    p = _grid(240, 320)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g["kp1_count"], g["kp2_count"]) == (w["kp1_count"],
                                                    w["kp2_count"]), i
        assert _close_count(g["num_matches"], w["num_matches"], 0.02), i
        assert _close_count(g["num_inliers"], w["num_inliers"], 0.03), i
        assert _projection_gap(g["h"], w["h"], p) <= 0.05, i


def test_object_recognition_matches_image_equals_the_reference(objrec):
    name = "object_recognition_matches.png"
    want = np.asarray(Image.open(os.path.join(objrec["ref"][2], name)))
    got = np.asarray(Image.open(os.path.join(objrec["port"][2], name)))
    assert got.shape == want.shape == (240, 640, 3)
    np.testing.assert_array_equal(got, want)


def test_object_recognition_animation_against_the_reference(objrec):
    name = "object_recognition.gif"
    want = _frames(os.path.join(objrec["ref"][2], name))
    got = _frames(os.path.join(objrec["port"][2], name))
    assert len(got) == len(want) == 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (240, 320, 3)
        assert (g != w).any(axis=-1).sum() <= 0.001 * 240 * 320, i


# ------------------------------------------------------- planar_tracking

def test_planar_tracking_prints_the_reference_lines(planar):
    want = er.parse("planar_tracking", planar["ref"][0])
    got = er.parse("planar_tracking", planar["port"][0])
    assert want["tracked"] == [True] * 6
    assert got["tracked"] == want["tracked"]
    assert len(got["inliers"]) == len(want["inliers"]) == 6
    for g, w in zip(got["inliers"], want["inliers"]):
        assert _close_count(g, w, 0.03)
    assert abs(got["ate"] - want["ate"]) <= 0.05 + 1e-3


def test_planar_tracking_trajectory_within_the_frontend_bars(planar):
    want = planar["ref"][1]
    got = planar["port"][1]
    wt, gt = want["track_planar_sequence"][0], got["track_planar_sequence"][0]
    assert gt["tracked"] == wt["tracked"]
    p = _grid(200, 280)
    for g, w in zip(gt["h_to_first"], wt["h_to_first"], strict=True):
        assert _projection_gap(g, w, p) <= 0.05
    assert abs(got["ate_rmse"][0] - want["ate_rmse"][0]) <= 0.05


# ------------------------------------------------------------- live_demo

def test_live_demo_serves_frames_like_the_reference(live):
    want = er.parse("live_demo", live["ref"][0])
    got = er.parse("live_demo", live["port"][0])
    assert want["frames"] == got["frames"] == LIVE_FRAMES
    assert want["port"] > 0 and got["port"] > 0
    assert set(got) == set(want) and got["wrote"] == want["wrote"] == []
    result = live["port"][1]
    assert result["stats"]["frames"] == got["frames"]


def test_live_demo_last_frame_is_the_reference_drawing(live):
    import jax.numpy as jnp

    from compv_tpu.features.orb import OrbConfig, orb_detect_describe
    from compv_tpu.io.camera import SyntheticCamera
    from compv_tpu.viz import draw_keypoints, draw_text

    result = live["port"][1]
    n = result["frames_drawn"]
    assert n == LIVE_FRAMES
    frame = SyntheticCamera(width=640, height=480).frame_at(n - 1)
    res = orb_detect_describe(jnp.asarray(frame),
                              OrbConfig(max_features=256, levels=3))
    want = draw_text(draw_keypoints(frame, res.keypoints), 4, 4,
                     f"frame {n}  kp {int(res.keypoints.valid.sum())}")
    got = result["last"]
    assert got.shape == want.shape == (480, 640, 3)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- common, no fallback

@pytest.mark.parametrize("shape,seed", [((240, 320), 5), ((200, 280), 5),
                                        ((96, 128), 5), ((37, 53), 11)])
def test_textured_scene_equals_the_reference(shape, seed):
    """examples_torch/common.py's copy of examples/common.py's scene. The
    reference's module is loaded under another name (``common`` is the
    port's here); it sets up JAX on the CPU, as this suite's conftest has."""
    spec = importlib.util.spec_from_file_location(
        "reference_examples_common", os.path.join(_ROOT, "examples",
                                                  "common.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = ref.textured_scene(*shape, seed=seed)
    got = er.load_port("common").textured_scene(*shape, seed=seed)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_out_path_is_the_reference_layout(tmp_path):
    common = er.load_port("common")
    d = os.path.join(_ROOT, "examples_torch", "out")
    assert common.out_path("x.png") == os.path.join(d, "x.png")
    assert os.path.isdir(d)


@pytest.mark.parametrize("name,args", [
    ("object_recognition", []), ("planar_tracking", []),
    ("live_demo", ["--seconds", "1", "--port", "0"])])
def test_program_without_device_needs_the_card(name, args, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the program would run on it")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        er.run_port(name, args, str(tmp_path))
    assert os.listdir(tmp_path) == []
