"""Port parity of ``slam/pipeline.py`` (planar tracking, homography
decomposition, the keyframe store) against ``compv_tpu`` on the same numpy
frames (CPU), with the reference's bar (``tests/test_slam_io.py:121-141``).

Tolerances, each with its reason:
* tracked flags and per-frame inlier counts: exact (ORB, the matcher and
  the RANSAC samples are bit-exact; the inliers are integer counts);
* chained homographies: 1e-3 absolute on the translation entries and
  1e-5 on the rest (the refining DLT is an f32 eigh of two LAPACK
  builds; chaining multiplies the rounding), and within 1.5 px of the true
  shifts, the reference's bar;
* ``decompose_homography``: 1e-5 absolute (a 3 x 3 SVD of two LAPACK
  builds; the result does not depend on the singular vectors' signs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from compv_tpu.slam import pipeline as jpl
from compv_tpu_torch.interop import config_from_reference
from compv_tpu_torch.slam import pipeline as tpl


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


@pytest.fixture(scope="module")
def base():
    rs = np.random.default_rng(5)
    img = ndimage.gaussian_filter(
        rs.uniform(0, 255, (200, 280)).astype(np.float32), 1.5)
    return ((img - img.min()) / np.ptp(img) * 255).astype(np.uint8)


def _same_track(got, want):
    assert got.tracked == want.tracked
    assert got.num_inliers == want.num_inliers
    for hg, hw in zip(got.h_to_first, want.h_to_first):
        np.testing.assert_allclose(hg[:, 2], hw[:, 2], atol=1e-3)
        np.testing.assert_allclose(hg[:, :2], hw[:, :2], atol=1e-5)


def test_translating_sequence(base):
    shifts = [0, 4, 8, 12, 16]
    frames = [np.roll(base, s, axis=1) for s in shifts]
    jcfg = jpl.PlanarTrackerConfig()
    want = jpl.track_planar_sequence(frames, jcfg)
    got = tpl.track_planar_sequence(frames, config_from_reference(jcfg),
                                    device="cpu")
    assert all(got.tracked)
    for h, s in zip(got.h_to_first, shifts):
        assert abs(h[0, 2] - s) < 1.5 and abs(h[1, 2]) < 1.5
    _same_track(got, want)
    # tensors in stay on their device
    again = tpl.track_planar_sequence([torch.from_numpy(f) for f in frames],
                                      config_from_reference(jcfg))
    _same_track(again, want)


def test_relocalization_branch(base):
    """A frame of noise breaks the chain; the next frame is found again
    against the template (the reference's re-localization)."""
    rs = np.random.default_rng(9)
    noise = rs.integers(0, 256, base.shape, dtype=np.uint8)
    frames = [base, np.roll(base, 4, axis=1), noise,
              np.roll(base, 12, axis=1)]
    want = jpl.track_planar_sequence(frames)
    got = tpl.track_planar_sequence(frames, device="cpu")
    assert got.tracked == [True, True, False, True]
    assert abs(got.h_to_first[3][0, 2] - 12) < 1.5
    _same_track(got, want)


def test_numpy_frames_need_the_card(base):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tpl.track_planar_sequence([base, base])


def test_decompose_homography_equals_reference():
    rs = np.random.default_rng(3)
    k = np.array([[500, 0, 140], [0, 510, 100], [0, 0, 1.0]], np.float32)
    for _ in range(5):
        h = (np.eye(3) + rs.normal(0, 0.02, (3, 3))
             * np.array([[1, 1, 100], [1, 1, 100], [1e-4, 1e-4, 0]])
             ).astype(np.float32)
        want = jpl.decompose_homography(jnp.asarray(h), jnp.asarray(k))
        got = tpl.decompose_homography(torch.from_numpy(h),
                                       torch.from_numpy(k))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-5)


def test_keyframe_store(base):
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    store = tpl.KeyframeStore(capacity=2)
    orb = orb_detect_describe(torch.from_numpy(base),
                              OrbConfig(max_features=64, levels=2))
    assert store.add(0, orb, np.eye(4)) and store.add(5, orb, np.eye(4))
    assert not store.add(6, orb, np.eye(4))
    assert len(store) == 2 and store.frame_ids == [0, 5]
    desc, valid = store.stacked_descriptors()
    assert desc.shape == (2, 64, 256) and valid.shape == (2, 64)
    assert torch.equal(desc[1], orb.descriptors)


def test_tracker_config_round_trip():
    cfg = config_from_reference(jpl.PlanarTrackerConfig())
    assert cfg == tpl.PlanarTrackerConfig()
    assert cfg.orb.max_features == 1000 and cfg.orb.levels == 4
    assert cfg.homography.num_hypotheses == 256
