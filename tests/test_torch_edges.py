"""Port parity for the edge detectors and Canny: ``sobel_gradients`` (all
three operators), ``edge_detect``, ``gradient_magnitude_direction`` and
``canny`` against ``compv_tpu`` on the same numpy inputs (CPU).

Tolerances: gradients, ``edge_detect`` and ``canny`` with fixed thresholds
are bit-equal (same shift-and-add order, same f32 constants, the
reference's hysteresis loop with its cap). ``threshold_type="mean"`` takes
a mean whose summation order is not XLA's: the means agree within 1e-6
relative, and the edge maps are equal on these images. The L2 magnitude of
``gradient_magnitude_direction`` is within an ulp, its direction
(``torch.atan2`` against XLA's ``arctan2``) within 1e-6 rad.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu_torch.features import edges
from compv_tpu_torch.interop import config_from_reference
from tests.fixtures import make_test_image

canny_mod = importlib.import_module("compv_tpu_torch.features.canny")
jcanny = importlib.import_module("compv_tpu.features.canny")
jedges = importlib.import_module("compv_tpu.features.edges")


def _step():
    img = np.zeros((64, 64), np.uint8)
    img[:, 32:] = 200
    return img


def _hysteresis():
    """tests/test_edges.py:69-86: strong ends, a weak middle."""
    img = np.zeros((40, 120), np.float32)
    img[20, :] = np.concatenate([np.full(40, 200.0), np.full(40, 90.0),
                                 np.full(40, 200.0)])
    return img.astype(np.uint8)


def _random(seed=0, shape=(37, 53)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


IMAGES = {"golden": make_test_image, "step": _step,
          "hysteresis": _hysteresis, "random": _random}


def _canny_pair(img, cfg):
    want = np.asarray(jcanny.canny(jnp.asarray(img), cfg))
    got = canny_mod.canny(torch.from_numpy(img), config_from_reference(cfg))
    return got.numpy(), want


def test_kernels_equal_the_reference():
    assert edges.KERNELS.keys() == jedges.KERNELS.keys()
    for name, (smooth, deriv) in jedges.KERNELS.items():
        np.testing.assert_array_equal(edges.KERNELS[name][0], smooth)
        np.testing.assert_array_equal(edges.KERNELS[name][1], deriv)


@pytest.mark.parametrize("operator", ["sobel", "scharr", "prewitt"])
@pytest.mark.parametrize("name", list(IMAGES))
def test_sobel_gradients_bit_equal(name, operator):
    img = IMAGES[name]()
    wx, wy = jedges.sobel_gradients(jnp.asarray(img), operator)
    gx, gy = edges.sobel_gradients(torch.from_numpy(img), operator)
    assert gx.dtype == torch.float32 and gx.shape == img.shape
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


@pytest.mark.parametrize("operator", ["sobel", "scharr", "prewitt"])
@pytest.mark.parametrize("scale", [None, 0.37])
def test_edge_detect_bit_equal(operator, scale):
    img = make_test_image()
    want = np.asarray(jedges.edge_detect(jnp.asarray(img), operator, scale))
    got = edges.edge_detect(torch.from_numpy(img), operator, scale)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("l2", [False, True])
def test_gradient_magnitude_direction(l2):
    img = _random(4)
    wx, wy = jedges.sobel_gradients(jnp.asarray(img))
    wm, wd = jedges.gradient_magnitude_direction(wx, wy, l2)
    gx, gy = edges.sobel_gradients(torch.from_numpy(img))
    m, d = edges.gradient_magnitude_direction(gx, gy, l2)
    # L1 is exact; L2 within an ulp (XLA:CPU's sqrt path rounds a few
    # values the other way)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=2.5e-7,
                               atol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,low,high", [
    ("golden", 59, 119), ("golden", 20, 60), ("step", 30, 80),
    ("hysteresis", 100, 300), ("hysteresis", 100, 650), ("random", 59, 119)])
def test_canny_fixed_bit_equal(name, low, high):
    got, want = _canny_pair(IMAGES[name](),
                            jcanny.CannyConfig(threshold_low=low,
                                               threshold_high=high))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 255}


def test_canny_hysteresis_keeps_the_weak_middle():
    got, _ = _canny_pair(_hysteresis(), jcanny.CannyConfig(100, 650))
    assert got[19:22, 45:75].max() > 0
    assert canny_mod.last_syncs >= 2


def test_canny_hysteresis_cap_is_the_references():
    """A weak chain of ~200 px grows 4 px per check: with 8 checks the
    reference stops part-way, and so does the port."""
    img = np.zeros((24, 240), np.uint8)
    img[12, 4:236] = 90
    img[12, 4:10] = 250                        # strong seed at the left end
    cfg = jcanny.CannyConfig(threshold_low=100, threshold_high=650,
                             max_hysteresis_iters=8)
    got, want = _canny_pair(img, cfg)
    np.testing.assert_array_equal(got, want)
    assert canny_mod.last_syncs == 8
    full, _ = _canny_pair(img, jcanny.CannyConfig(100, 650,
                                                  max_hysteresis_iters=200))
    assert (full > 0).sum() > (got > 0).sum() > 0


@pytest.mark.parametrize("name", list(IMAGES))
def test_canny_mean_threshold(name):
    """Mean mode: the two means agree within 1e-6 relative (on the random
    image they differ by an ulp, the summation order); the edge maps are
    equal on all four images, as no thinned magnitude sits between the two
    thresholds."""
    img = IMAGES[name]()
    wx, wy = jedges.sobel_gradients(jnp.asarray(img))
    want_mean = float(jnp.mean(jnp.abs(wx) + jnp.abs(wy)))
    gx, gy = edges.sobel_gradients(torch.from_numpy(img))
    got_mean = float((gx.abs() + gy.abs()).mean())
    assert got_mean == pytest.approx(want_mean, rel=1e-6, abs=0)
    got, want = _canny_pair(img, jcanny.CannyConfig(66, 133, "mean"))
    np.testing.assert_array_equal(got, want)


def test_canny_flat_image_has_no_edges():
    got, want = _canny_pair(np.full((32, 32), 77, np.uint8),
                            jcanny.CannyConfig())
    assert got.sum() == 0 and want.sum() == 0


def test_canny_config_round_trip():
    cfg = jcanny.CannyConfig(12.5, 70.0, "mean", 9)
    port = config_from_reference(cfg)
    assert isinstance(port, canny_mod.CannyConfig)
    assert port == canny_mod.CannyConfig(12.5, 70.0, "mean", 9)
