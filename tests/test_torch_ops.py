"""Port parity, rows 2-9 of the slice: the port's core types, top-k,
threefry stream, gray conversion, pyramid helpers, bilinear scale, blur and
bit packing against ``compv_tpu`` on the same numpy inputs (CPU)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.core.types import Keypoints as JKeypoints
from compv_tpu.image import color as jcolor
from compv_tpu.image import pyramid as jpyr
from compv_tpu.image.scale import scale_bilinear as jscale_bilinear
from compv_tpu.ops import bitops as jbits
from compv_tpu.ops import conv as jconv
from compv_tpu.ops import topk as jtopk
from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.image import color, pyramid
from compv_tpu_torch.image.scale import scale, scale_bilinear
from compv_tpu_torch.interop import keypoints_from_numpy, keypoints_to_numpy
from compv_tpu_torch.ops import bitops, conv, threefry, topk
from tests.fixtures import make_test_image, make_test_rgb

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        return json.load(f)


def _md5(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.md5(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()


# ---------------------------------------------------------------- row 3

@pytest.mark.parametrize("seed,n,k", [(0, 7, 3), (1, 1000, 37), (2, 4096, 500)])
def test_select_top_k_tie_order_matches_lax(seed, n, k):
    # small integer range: most values tie, so the tie rule decides
    x = np.random.default_rng(seed).integers(0, 5, n).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = topk.select_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_select_top_k_known_ties():
    _, idx = topk.select_top_k(torch.tensor([1., 3, 3, 2, 3, 0, 3]), 3)
    assert idx.tolist() == [1, 2, 4]


def test_select_top_k_2d_matches_reference():
    s = np.random.default_rng(3).integers(0, 4, (37, 53)).astype(np.float32)
    want_v, want_i = jtopk.select_top_k_2d(jnp.asarray(s), 200)
    got_v, got_i = topk.select_top_k_2d(torch.from_numpy(s), 200)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_select_top_k_rows_with_neg_inf():
    x = np.random.default_rng(4).integers(-3, 3, (6, 40)).astype(np.float32)
    x[x < -2] = -np.inf
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 5)
    got_v, got_i = topk.select_top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------- row 4

@pytest.mark.parametrize("seed,shape", [(0, (512, 200)), (7, (3, 5)),
                                        (123456789, (1, 1)), (1, (17,))])
def test_threefry_bits_bit_exact(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                      jnp.uint32))
    got = threefry.random_bits(seed, shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed,shape", [(0, (128, 301)), (5, (4, 4))])
def test_threefry_uniform_bit_exact(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = threefry.uniform(seed, shape).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry_key_matches_prngkey():
    for seed in (0, 1, 2 ** 31 - 1):
        want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        assert threefry.prng_key(seed) == tuple(int(v) for v in want)
    with pytest.raises(ValueError):
        threefry.prng_key(-1)


# ---------------------------------------------------------------- row 5

def test_rgb_to_gray_exact_and_golden(goldens):
    rgb = make_test_rgb()
    got = color.rgb_to_gray(torch.from_numpy(rgb))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb))))
    assert _md5(got) == goldens["md5_to_gray"]


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_to_gray_matches_reference(channels):
    rs = np.random.default_rng(5)
    shape = (9, 11) if channels is None else (9, 11, channels)
    img = rs.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        color.to_gray(torch.from_numpy(img)).numpy(),
        np.asarray(jcolor.to_gray(jnp.asarray(img))))


def test_to_gray_rejects_two_channels():
    with pytest.raises(ValueError):
        color.to_gray(torch.zeros((4, 4, 2), dtype=torch.uint8))


# ---------------------------------------------------------------- row 6

@pytest.mark.parametrize("h,w,levels,sf", [(720, 1282, 8, 0.83),
                                           (120, 160, 3, 0.83),
                                           (1, 1, 4, 0.5), (33, 47, 6, 0.9)])
def test_pyramid_helpers_equal_reference(h, w, levels, sf):
    assert pyramid.pyramid_sizes(h, w, levels, sf) == jpyr.pyramid_sizes(
        h, w, levels, sf)
    assert pyramid.scale_factors(levels, sf) == jpyr.scale_factors(levels, sf)
    assert pyramid.scale_factors_sum(levels, sf) == jpyr.scale_factors_sum(
        levels, sf)


# ---------------------------------------------------------------- row 7

def test_scale_bilinear_golden(goldens):
    got = scale_bilinear(torch.from_numpy(make_test_image()), 299, 401)
    assert _md5(got) == goldens["md5_scale_bilinear_299x401"]


@pytest.mark.parametrize("src,dst", [((120, 160), (100, 133)),
                                     ((120, 160), (83, 110)),
                                     ((37, 29), (80, 61)), ((5, 7), (1, 1))])
def test_scale_bilinear_exact(src, dst):
    img = np.random.default_rng(6).integers(0, 256, src, dtype=np.uint8)
    want = np.asarray(jscale_bilinear(jnp.asarray(img), *dst))
    got = scale(torch.from_numpy(img), *dst, "bilinear")
    np.testing.assert_array_equal(got.numpy(), want)


def test_scale_bilinear_f32_and_rgb():
    rs = np.random.default_rng(7)
    f = rs.uniform(0, 1, (21, 34)).astype(np.float32)
    np.testing.assert_array_equal(
        scale_bilinear(torch.from_numpy(f), 13, 50).numpy(),
        np.asarray(jscale_bilinear(jnp.asarray(f), 13, 50)))
    rgb = rs.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        scale_bilinear(torch.from_numpy(rgb), 17, 19).numpy(),
        np.asarray(jscale_bilinear(jnp.asarray(rgb), 17, 19)))


# ---------------------------------------------------------------- row 8

@pytest.mark.parametrize("size,sigma", [(5, 2.0), (7, 1.2), (3, 0.8)])
def test_gaussian_kernel1d_equals_reference(size, sigma):
    np.testing.assert_array_equal(
        conv.gaussian_kernel1d(size, sigma).numpy(),
        np.asarray(jconv.gaussian_kernel1d(size, sigma)))


@pytest.mark.parametrize("border", ["zero", "replicate"])
def test_gaussian_blur_u8_exact(border):
    img = make_test_image(120, 160)
    want = np.asarray(jconv.gaussian_blur(jnp.asarray(img), 5, 2.0, border))
    got = conv.gaussian_blur(torch.from_numpy(img), 5, 2.0, border)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_convolve_separable_f32_exact():
    rs = np.random.default_rng(8)
    img = rs.uniform(0, 255, (31, 45)).astype(np.float32)
    kh = np.asarray([0.25, 0.5, 0.25], np.float32)
    kv = np.asarray(jconv.gaussian_kernel1d(5, 2.0))
    want = np.asarray(jconv.convolve_separable(jnp.asarray(img),
                                               jnp.asarray(kh), jnp.asarray(kv)))
    got = conv.convolve_separable(torch.from_numpy(img), kh, kv)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- row 9

def test_pack_unpack_bits_exact():
    bits = np.random.default_rng(9).integers(0, 2, (13, 256), dtype=np.uint8)
    packed = bitops.pack_bits_to_bytes(torch.from_numpy(bits))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jbits.pack_bits_to_bytes(jnp.asarray(bits))))
    unpacked = bitops.unpack_bytes_to_bits(packed)
    np.testing.assert_array_equal(
        unpacked.numpy(),
        np.asarray(jbits.unpack_bytes_to_bits(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(unpacked.numpy(), bits)


# ---------------------------------------------------------------- row 2

def _random_keypoints(n=50, seed=10):
    rs = np.random.default_rng(seed)
    return JKeypoints(
        x=jnp.asarray(rs.uniform(0, 100, n), jnp.float32),
        y=jnp.asarray(rs.uniform(0, 80, n), jnp.float32),
        strength=jnp.asarray(rs.integers(0, 6, n), jnp.float32),  # ties
        orientation=jnp.asarray(rs.uniform(0, 360, n), jnp.float32),
        level=jnp.asarray(rs.integers(0, 3, n), jnp.int32),
        size=jnp.asarray(rs.uniform(7, 40, n), jnp.float32),
        valid=jnp.asarray(rs.random(n) < 0.8))


def _assert_keypoints_equal(port_kp, ref_kp):
    got = keypoints_to_numpy(port_kp)
    for name in JKeypoints._fields:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(ref_kp, name)),
                                      err_msg=name)


def test_keypoints_methods_match_reference():
    ref = _random_keypoints()
    kp = keypoints_from_numpy(ref)
    assert kp.capacity == ref.capacity
    assert int(kp.count()) == int(ref.count())
    _assert_keypoints_equal(kp.select_best(17), ref.select_best(17))
    _assert_keypoints_equal(kp.erase_near_border(100, 80, 15.5, 15.5),
                            ref.erase_near_border(100, 80, 15.5, 15.5))
    _assert_keypoints_equal(Keypoints.empty(9), JKeypoints.empty(9))
