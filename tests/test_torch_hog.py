"""Port parity of ``features/hog.py`` against ``compv_tpu`` on the same
numpy inputs (CPU): 64 x 128 and 96 x 160 images (random, and crops of
bench.py's scene with its checkerboard patch), a size that is no multiple
of the cell, every interpolation mode with L2-Hys and every norm with
``bilinear``, unsigned and signed gradients.

Tolerances, each with its reason:
* ``gradient_fast``: exact (the same f32 differences; not jitted in the
  reference);
* ``bilinear`` (continuous in the angle): 2e-6 times max(1, the largest
  descriptor value); ``l1sqrt`` on the squares of its values (a square
  root near 0 widens an ulp of its argument to ~4e-5); the jitted
  reference sums cells and blocks in XLA's order, may fuse multiply-adds
  and take rsqrt for 1 / sqrt, and its ``arctan2`` may differ from
  ``torch.atan2`` by an ulp;
* ``nearest`` and ``bilinear_lut`` (step functions of the angle): the
  pixels whose vote moves to another bin are counted with one-pixel cells
  (``cell_size=1``, no normalization: the descriptor is each pixel's
  votes). On the images here: 0 move in ``nearest``, 0 on the scene crops
  and 1 of 15,360 on the random 96 x 160 image in ``bilinear_lut`` (an ulp
  of atan2 at a quantization step's edge); where none moves, the
  descriptor is held to the ``bilinear`` tolerance.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.features import hog as jhog
from compv_tpu_torch.features import hog as thog
from compv_tpu_torch.interop import config_from_reference

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def images():
    spec = importlib.util.spec_from_file_location(
        "compv_bench", os.path.join(_ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    scene = bench._images()[0]
    rs = np.random.default_rng(0)
    return {"random_64x128": rs.integers(0, 256, (64, 128), dtype=np.uint8),
            "random_96x160": rs.integers(0, 256, (96, 160), dtype=np.uint8),
            "scene_64x128": np.ascontiguousarray(scene[120:184, 260:388]),
            "scene_96x160": np.ascontiguousarray(scene[500:596, 900:1060]),
            "scene_67x131": np.ascontiguousarray(scene[140:207, 280:411])}


# pixels whose vote moves to another bin, by (mode, image); absent: 0
_MOVED = {("bilinear_lut", "random_96x160"): 1}


def _ref(img, cfg):
    return np.asarray(jhog.hog_descriptor(jnp.asarray(img), cfg))


def _port(img, cfg):
    return thog.hog_descriptor(torch.from_numpy(img),
                               config_from_reference(cfg)).numpy()


def _moved_pixels(img, interp, signed):
    """Pixels whose votes differ, with one-pixel cells and no norm."""
    cfg = jhog.HogConfig(cell_size=1, block_size=1, norm="none",
                         interp=interp, signed_gradient=signed)
    want = _ref(img, cfg)
    got = _port(img, cfg)
    mag = np.maximum(np.abs(want).sum(-1), 1.0)
    return int((np.abs(got - want) > 1e-4 * mag[..., None]).any(-1).sum())


def _assert_close(got, want, norm):
    assert got.shape == want.shape and got.dtype == np.float32
    if norm == "l1sqrt":        # held on the L1 values it takes roots of
        got, want = got * got, want * want
    tol = 2e-6 * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def test_gradient_fast_exact(images):
    for img in images.values():
        for got, want in zip(thog.gradient_fast(torch.from_numpy(img)),
                             jhog.gradient_fast(jnp.asarray(img))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("norm", ["none", "l1", "l1sqrt", "l2", "l2hys"])
def test_bilinear_every_norm(images, norm, signed):
    cfg = jhog.HogConfig(norm=norm, signed_gradient=signed)
    for img in images.values():
        _assert_close(_port(img, cfg), _ref(img, cfg), norm)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("interp", ["nearest", "bilinear_lut"])
def test_step_modes_count_moved_bins(images, interp, signed):
    cfg = jhog.HogConfig(interp=interp, norm="l2hys", signed_gradient=signed)
    for name, img in images.items():
        moved = _moved_pixels(img, interp, signed)
        assert moved == _MOVED.get((interp, name), 0), (name, moved)
        if moved == 0:
            _assert_close(_port(img, cfg), _ref(img, cfg), "l2hys")


def test_block_geometry_and_crop(images):
    img = images["scene_67x131"]
    for cfg in (jhog.HogConfig(), jhog.HogConfig(cell_size=6, block_size=3,
                                                 block_stride=2, nbins=12),
                jhog.HogConfig(block_size=1, norm="l1", lut_bins=256,
                               interp="bilinear_lut")):
        got, want = _port(img, cfg), _ref(img, cfg)
        assert got.shape == want.shape
        _assert_close(got, want, cfg.norm)
    ours = thog.hog_descriptor(torch.from_numpy(img))
    assert ours.shape == (7, 15, 36)
    assert torch.equal(ours, thog.hog_descriptor(torch.from_numpy(img)))


def test_config_and_errors():
    cfg = jhog.HogConfig(cell_size=4, interp="nearest", l2hys_clip=0.3)
    assert config_from_reference(cfg) == thog.HogConfig(
        cell_size=4, interp="nearest", l2hys_clip=0.3)
    img = torch.zeros(16, 16, dtype=torch.uint8)
    with pytest.raises(ValueError):
        thog.hog_descriptor(img, thog.HogConfig(norm="l3"))
    with pytest.raises(ValueError):
        thog.hog_descriptor(img, thog.HogConfig(interp="cubic"))
