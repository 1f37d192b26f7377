"""Port parity, row 12 of the slice: ``features/orb.py`` against
``compv_tpu`` on the same numpy inputs (CPU, small size: 120x160 scene,
levels=3, max_features=256).

Tolerances, each with its reason:
* keypoint x / y / strength / level / size / valid, moment maps, budgets
  and sub-pixel offsets: exact (integer maps, the same f32 operations);
* orientation on equal inputs: 1e-4 deg — atan2 differs by an ulp between
  XLA:CPU and torch (1 ulp is 3e-5 deg near 360);
* orientation inside the full pipeline: 1e-4 deg at level 0 (measured
  3e-5, the ulp of atan2); 0.05 deg at levels >= 1 (measured up to 0.022),
  because the reference's jitted pipeline fuses the bilinear
  level image into its consumers and XLA:CPU then rounds a few level
  pixels differently (by 1) from its own standalone ``scale_bilinear``,
  which the md5 golden locks and the port matches; one such pixel moves a
  disc moment by at most 15;
* BRIEF bits on equal inputs: exact (measured; the issue allowed 0.1 %);
  inside the full pipeline at most 0.1 % differ — a rotated test offset
  rounds at .5, where an ulp of cos/sin or the level pixel above can flip
  it (measured 0.0015 %).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.features import orb as jorb
from compv_tpu_torch.features import orb
from compv_tpu_torch.interop import config_from_reference
from compv_tpu_torch.ops.conv import gaussian_blur

CFG = jorb.OrbConfig(max_features=256, levels=3)


def _scene(h=120, w=160, seed=0):
    """Gradient + checkerboard patch + noise, the bench scene at small size."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > w * 0.2) & (xx < w * 0.8) & (yy > h * 0.2)
                    & (yy < h * 0.8), ch * 200.0 + 20, base)
    return np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def reference_keypoints(scene):
    """Level-0 keypoints of the reference detector (levels=1): integer
    positions, orientations and validity to feed both packages."""
    r = jorb.orb_detect_describe(jnp.asarray(scene),
                                 jorb.OrbConfig(max_features=128, levels=1,
                                                subpixel=False))
    kp = r.keypoints
    return (np.array(kp.x), np.array(kp.y), np.array(kp.orientation),
            np.array(kp.valid))


def test_brief_pattern_equals_reference():
    np.testing.assert_array_equal(orb._PATTERN, jorb._PATTERN)
    np.testing.assert_array_equal(orb.brief_pattern(64, 21, 5),
                                  jorb.brief_pattern(64, 21, 5))


@pytest.mark.parametrize("cfg", [CFG, jorb.OrbConfig(),
                                 jorb.OrbConfig(max_features=50, levels=4)])
def test_level_budgets_equal_reference(cfg):
    assert orb._level_budgets(config_from_reference(cfg)) == \
        jorb._level_budgets(cfg)


def test_moment_maps_exact(scene):
    m10 = jax.jit(jorb._m10_map)
    np.testing.assert_array_equal(orb._m10_map(torch.from_numpy(scene)).numpy(),
                                  np.asarray(m10(jnp.asarray(scene))))
    t = torch.from_numpy(scene).T
    np.testing.assert_array_equal(orb._m10_map(t).T.numpy(),
                                  np.asarray(m10(jnp.asarray(scene).T)).T)


def test_patch_orientation_on_equal_inputs(scene, reference_keypoints):
    x, y, _, valid = reference_keypoints
    want = np.asarray(jax.jit(jorb.patch_orientation)(
        jnp.asarray(scene), jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid)))
    got = orb.patch_orientation(torch.from_numpy(scene), torch.from_numpy(x),
                                torch.from_numpy(y), torch.from_numpy(valid))
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_brief_describe_on_equal_inputs(scene, reference_keypoints):
    x, y, orient, valid = reference_keypoints
    blurred = np.array(jorb.gaussian_blur(jnp.asarray(scene), 5, 2.0))
    np.testing.assert_array_equal(
        gaussian_blur(torch.from_numpy(scene), 5, 2.0).numpy(), blurred)
    want = np.asarray(jorb.brief_describe(
        jnp.asarray(blurred), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(orient), jnp.asarray(valid)))
    got = orb.brief_describe(torch.from_numpy(blurred), torch.from_numpy(x),
                             torch.from_numpy(y), torch.from_numpy(orient),
                             torch.from_numpy(valid)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not got[~valid].any()


def test_subpixel_offsets_exact(scene, reference_keypoints):
    x, y, _, valid = reference_keypoints
    s = np.array(jorb._strengths_f32(jnp.asarray(scene), 20, 9))
    want = jorb._subpixel_offsets(jnp.asarray(s), jnp.asarray(x[valid]),
                                  jnp.asarray(y[valid]))
    got = orb._subpixel_offsets(torch.from_numpy(s), torch.from_numpy(x[valid]),
                                torch.from_numpy(y[valid]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _compare_orb(img, cfg, level0_tol, upper_tol):
    ref = jorb.orb_detect_describe(jnp.asarray(img), cfg)
    got = orb.orb_detect_describe(torch.from_numpy(img),
                                  config_from_reference(cfg))
    for name in ("x", "y", "strength", "level", "size", "valid"):
        np.testing.assert_array_equal(getattr(got.keypoints, name).numpy(),
                                      np.asarray(getattr(ref.keypoints, name)),
                                      err_msg=name)
    level = np.asarray(ref.keypoints.level)
    d = np.abs(got.keypoints.orientation.numpy()
               - np.asarray(ref.keypoints.orientation))
    d = np.minimum(d, 360.0 - d)
    assert d[level == 0].max(initial=0.0) <= level0_tol
    assert d[level > 0].max(initial=0.0) <= upper_tol
    bits = got.descriptors.numpy()
    assert bits.shape == (cfg.max_features, 256)
    assert (bits != np.asarray(ref.descriptors)).mean() <= 1e-3
    np.testing.assert_array_equal(got.packed().numpy(),
                                  np.asarray(jorb.pack_bits_to_bytes(
                                      jnp.asarray(bits))))
    return got


@pytest.mark.parametrize("seed,roll", [(0, (0, 0)), (0, (4, 7)), (3, (0, 0))])
def test_orb_detect_describe_matches_reference(seed, roll):
    img = np.roll(_scene(seed=seed), roll, (0, 1))
    got = _compare_orb(img, CFG, 1e-4, 0.05)
    assert int(got.keypoints.count()) > 50


def test_orb_level0_only_matches_reference(scene):
    _compare_orb(scene, jorb.OrbConfig(max_features=128, levels=1,
                                       subpixel=False), 1e-4, 1e-4)


def test_orb_without_nms_matches_reference(scene):
    _compare_orb(scene, jorb.OrbConfig(max_features=128, levels=2, nms=False),
                 1e-4, 0.05)


def test_orb_tiny_image_is_empty_like_reference():
    img = _scene(20, 24)
    ref = jorb.orb_detect_describe(jnp.asarray(img), CFG)
    got = orb.orb_detect_describe(torch.from_numpy(img),
                                  config_from_reference(CFG))
    for name in ref.keypoints._fields:
        np.testing.assert_array_equal(getattr(got.keypoints, name).numpy(),
                                      np.asarray(getattr(ref.keypoints, name)))
    np.testing.assert_array_equal(got.descriptors.numpy(),
                                  np.asarray(ref.descriptors))
