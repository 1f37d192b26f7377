"""Port parity of the image-op leftovers: ``ops/conv.py`` (2-D kernels and
convolution, the library branch above 31 taps, the Q0.16 fixed-point blur),
``image/scale.py`` (nearest, bicubic, both rotations) and
``image/pyramid.py`` (``Pyramid``, ``build_pyramid``) against
``compv_tpu`` on the same numpy inputs (CPU).

Tolerances, each with its reason:
* ``convolve_separable_q16`` / ``gaussian_blur_q16``: bit-exact, against
  the reference and against the scalar oracle of ``tests/test_conv_q16.py``
  (integer arithmetic);
* ``scale_nearest``, ``scale_bicubic``, ``scale_bilinear`` (u8 and f32),
  ``_roll_lines``, ``rotate_fast``: bit-exact (the same f32 operations in
  the same order; the shear factors agree to the bit at the test angles);
* ``rotate_bilinear``: u8 pixels within 1, at most 0.1 % of them (cos and
  sin of two math libraries move a sample position by an ulp);
* shift-and-add ``convolve2d`` up to 7 x 7: exact; 9 x 9 and 11 x 11, whose
  stencil the reference sums in XLA's convolution: 1e-6 absolute on values
  in [0, 1]; the separable library branch (33 and 41 taps): 1e-6 absolute.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.image import pyramid as jpyr
from compv_tpu.ops import conv as jconv
from compv_tpu_torch.image import pyramid as tpyr
from compv_tpu_torch.ops import conv as tconv

# the modules: each package exports its ``scale`` function under that name
jscale = importlib.import_module("compv_tpu.image.scale")
tscale = importlib.import_module("compv_tpu_torch.image.scale")


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


def _oracle_pass(img, kern, axis):
    """Scalar Q0.16 pass: a copy of tests/test_conv_q16.py's oracle."""
    taps = len(kern)
    r = taps // 2
    h, w = img.shape
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    p = np.pad(img.astype(np.uint32), pad)
    out = np.zeros((h, w), np.uint32)
    for t in range(taps):
        sl = p[t:t + h, :] if axis == 0 else p[:, t:t + w]
        out += (sl * np.uint32(kern[t])) >> 16
    return np.minimum(out, 255).astype(np.uint8)


def _wave(h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 128 + 60 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- conv

@pytest.mark.parametrize("size,sigma", [(3, 1.0), (5, 2.0), (7, 1.5)])
def test_q16_bit_exact(size, sigma):
    rs = np.random.default_rng(3)
    img = rs.integers(0, 256, (37, 53), np.uint8)
    k = np.asarray(jconv.gaussian_kernel1d(size, sigma))
    kq = tconv.fixed_point_kernel(k)
    np.testing.assert_array_equal(kq, jconv.fixed_point_kernel(k))
    assert kq.dtype == np.uint16
    kt = tuple(map(int, kq))
    got = tconv.convolve_separable_q16(torch.from_numpy(img), kt, kt).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jconv.convolve_separable_q16(jnp.asarray(img), kt, kt)))
    np.testing.assert_array_equal(
        got, _oracle_pass(_oracle_pass(img, kq, 0), kq, 1))


def test_gaussian_blur_q16():
    rs = np.random.default_rng(4)
    img = rs.integers(0, 256, (64, 64), np.uint8)
    got = tconv.gaussian_blur_q16(torch.from_numpy(img), 5, 2.0)
    assert got.dtype == torch.uint8 and got.shape == (64, 64)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jconv.gaussian_blur_q16(jnp.asarray(img))))
    ff = tconv.gaussian_blur(torch.from_numpy(img), 5, 2.0).numpy()
    assert np.abs(got.numpy().astype(int) - ff)[3:-3, 3:-3].max() <= 12
    with pytest.raises(ValueError):
        tconv.fixed_point_kernel([-0.1, 1.1])


@pytest.mark.parametrize("size,sigma", [(3, 0.8), (5, 2.0), (9, 3.0)])
def test_gaussian_kernel2d_equals_reference(size, sigma):
    np.testing.assert_array_equal(
        tconv.gaussian_kernel2d(size, sigma).numpy(),
        np.asarray(jconv.gaussian_kernel2d(size, sigma)))


@pytest.mark.parametrize("k", [3, 7, 9, 11])
@pytest.mark.parametrize("border", ["zero", "replicate"])
def test_convolve2d(k, border):
    rs = np.random.default_rng(k)
    img = rs.uniform(0, 1, (61, 77)).astype(np.float32)
    kern = np.asarray(jconv.gaussian_kernel2d(k, 2.0)).copy()
    kern[0, 0] = 0.0                 # a zero tap, skipped by both packages
    want = np.asarray(jconv.convolve2d(jnp.asarray(img), jnp.asarray(kern),
                                       border))
    got = tconv.convolve2d(torch.from_numpy(img), kern, border).numpy()
    if k * k <= 62:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # batched and a tensor kernel give the same
    both = tconv.convolve2d(torch.from_numpy(np.stack([img, img])),
                            torch.from_numpy(kern), border)
    assert torch.equal(both[1], torch.from_numpy(got))


@pytest.mark.parametrize("taps", [33, 41])
@pytest.mark.parametrize("border", ["zero", "replicate"])
def test_convolve_separable_library_branch(taps, border):
    rs = np.random.default_rng(taps)
    img = rs.uniform(0, 1, (70, 90)).astype(np.float32)
    k = np.asarray(jconv.gaussian_kernel1d(taps, 6.0))
    want = np.asarray(jconv.convolve_separable(jnp.asarray(img),
                                               jnp.asarray(k), jnp.asarray(k),
                                               border))
    got = tconv.convolve_separable(torch.from_numpy(img), k, k, border)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- scale

@pytest.mark.parametrize("out", [(30, 41), (122, 150), (61, 77), (17, 200)])
@pytest.mark.parametrize("name", ["scale_nearest", "scale_bicubic"])
def test_scale_exact(out, name):
    rs = np.random.default_rng(0)
    for x in (rs.integers(0, 256, (61, 77), dtype=np.uint8),
              rs.uniform(0, 1, (61, 77)).astype(np.float32),
              rs.integers(0, 256, (40, 50, 3), dtype=np.uint8)):
        want = np.asarray(getattr(jscale, name)(jnp.asarray(x), *out))
        got = getattr(tscale, name)(torch.from_numpy(x), *out)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic", "nearest"])
def test_scale_facade_and_pyramid(interp):
    img = _wave(99, 131)
    want = jpyr.build_pyramid(jnp.asarray(img), 4, 0.83, interp)
    got = tpyr.build_pyramid(torch.from_numpy(img), 4, 0.83, interp)
    assert isinstance(got, tpyr.Pyramid) and got.levels == 4
    assert got.factors == want.factors
    assert got.factors_sum == want.factors_sum
    for lv in range(4):
        np.testing.assert_array_equal(got.image_at(lv).numpy(),
                                      np.asarray(want.image_at(lv)))
    with pytest.raises(ValueError):
        tscale.scale(torch.from_numpy(img), 10, 10, "lanczos")


def test_roll_lines_exact():
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    for axis, shifts in ((1, [0, 1, 3, 7, -1, -3, 15, 16]),
                         (0, list(range(-8, 8)))):
        want = np.asarray(jscale._roll_lines(jnp.asarray(x),
                                             jnp.asarray(shifts), axis))
        got = tscale._roll_lines(torch.from_numpy(x), torch.tensor(shifts),
                                 axis)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("angle", [0.0, 10.0, -10.0, 30.0, 45.0, -37.5])
def test_rotate_fast_bit_exact(angle):
    img = _wave()
    want = np.asarray(jscale.rotate_fast(jnp.asarray(img),
                                         jnp.float32(angle)))
    got = tscale.rotate_fast(torch.from_numpy(img), angle)
    np.testing.assert_array_equal(got.numpy(), want)
    again = tscale.rotate_fast(torch.from_numpy(img), torch.tensor(angle))
    assert torch.equal(got, again)


@pytest.mark.parametrize("angle", [10.0, -10.0, 30.0, 45.0])
def test_rotate_bilinear(angle):
    img = _wave()
    want = np.asarray(jscale.rotate_bilinear(jnp.asarray(img),
                                             jnp.float32(angle)))
    got = tscale.rotate_bilinear(torch.from_numpy(img), angle).numpy()
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
