"""Port parity of slice 4's image modules (``image/integral.py``,
``image/histogram.py``, ``image/threshold.py``, ``image/morph.py``,
``image/color.py``) against ``compv_tpu`` on the same numpy inputs (CPU),
and the four md5 goldens ``md5_rgb_to_hsv``, ``md5_integral``,
``md5_erode_3x3`` and ``md5_dilate_3x3``.

Tolerances, each with its reason:
* exact: every color, YUV, 565, HSV and HSL conversion, morphology,
  integer integral images and box sums, ``box_mean_var``'s centred int32
  path, the histogram, LUT, equalization and projections, the adaptive and
  Wolf thresholds (integer arithmetic, or the same f32 operations in the
  same order: none of these reference functions is jitted, so no fused
  multiply-add enters), and ``strel`` (a copy);
* float32 integral images (``integral`` of a float image,
  ``integral_squared``): 1e-6 relative to the largest entry (XLA and
  PyTorch sum a prefix in other orders; on the 720p scene 3.5e-7);
* ``box_mean_var``'s float32 path: the mean 1e-5 relative (prefix sums in
  another order, then a difference of two of them); the variance 1e-3
  relative to its largest value (a difference of box means of squares
  whose row prefixes reach ~1e9, where an f32 ulp is 64: the cancellation
  is the reference's, on 16,400-wide rows).
"""
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.image import color as jcolor
from compv_tpu.image import histogram as jhist
from compv_tpu.image import morph as jmorph
from compv_tpu.image import threshold as jthr
from compv_tpu_torch.core.golden import exact_hash
from compv_tpu_torch.image import color as tcolor
from compv_tpu_torch.image import histogram as thist
from compv_tpu_torch.image import morph as tmorph
from compv_tpu_torch.image import threshold as tthr
from tests.fixtures import make_test_image, make_test_rgb

# the modules: each package init exports a function named ``integral``
jint = importlib.import_module("compv_tpu.image.integral")
tint = importlib.import_module("compv_tpu_torch.image.integral")

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


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rel(got, want, rtol):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _rgb(seed=0, h=36, w=54):
    """Random RGB with the cases the branches turn on: grays (c = 0), ties
    of the largest channel, black, white, saturated primaries."""
    rs = np.random.default_rng(seed)
    rgb = rs.integers(0, 256, (h, w, 3), dtype=np.uint8)
    special = np.array([[0, 0, 0], [255, 255, 255], [128, 128, 128],
                        [255, 0, 0], [0, 255, 0], [0, 0, 255],
                        [200, 200, 10], [10, 200, 200], [200, 10, 200],
                        [255, 255, 0], [1, 0, 0], [0, 1, 1]], np.uint8)
    rgb[0, :len(special)] = special
    return rgb


# ---------------------------------------------------------------- color

@pytest.mark.parametrize("name", ["rgb_to_gray", "bgr_to_gray", "rgb_to_hsv",
                                  "rgb_to_hsl", "rgb_to_rgb565", "to_gray"])
def test_rgb_conversions_bit_exact(name):
    rgb = _rgb()
    _eq(getattr(tcolor, name)(torch.from_numpy(rgb)),
        getattr(jcolor, name)(jnp.asarray(rgb)))


def test_rgba_gray_yuv444_i420_split_merge():
    rgba = np.random.default_rng(1).integers(0, 256, (20, 30, 4),
                                             dtype=np.uint8)
    _eq(tcolor.rgba_to_gray(torch.from_numpy(rgba)),
        jcolor.rgba_to_gray(jnp.asarray(rgba)))
    _eq(tcolor.to_gray(torch.from_numpy(rgba)),
        jcolor.to_gray(jnp.asarray(rgba)))
    rgb = _rgb(2)
    for got, want in zip(tcolor.rgb_to_yuv444(torch.from_numpy(rgb)),
                         jcolor.rgb_to_yuv444(jnp.asarray(rgb))):
        _eq(got, want)
    for got, want in zip(tcolor.rgb_to_i420(torch.from_numpy(rgb)),
                         jcolor.rgb_to_i420(jnp.asarray(rgb))):
        _eq(got, want)
    planes = tcolor.split_channels(torch.from_numpy(rgb))
    for got, want in zip(planes, jcolor.split_channels(jnp.asarray(rgb))):
        _eq(got, want)
    _eq(tcolor.merge_channels(*planes), jcolor.merge_channels(
        *[jnp.asarray(p.numpy()) for p in planes]))


def test_yuv_to_rgb_family_bit_exact():
    rs = np.random.default_rng(3)
    h, w = 24, 38
    y = rs.integers(0, 256, (h, w), dtype=np.uint8)
    u2 = rs.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    v2 = rs.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    u4 = rs.integers(0, 256, (h, w), dtype=np.uint8)
    v4 = rs.integers(0, 256, (h, w), dtype=np.uint8)
    uh = rs.integers(0, 256, (h, w // 2), dtype=np.uint8)
    vh = rs.integers(0, 256, (h, w // 2), dtype=np.uint8)
    uv = np.stack([u2, v2], -1)
    packed = rs.integers(0, 256, (h, w * 2), dtype=np.uint8)
    t, j = torch.from_numpy, jnp.asarray
    _eq(tcolor.yuv_to_rgb(t(y), t(u4), t(v4)), jcolor.yuv_to_rgb(
        j(y), j(u4), j(v4)))
    _eq(tcolor.yuv444_to_hsv(t(y), t(u4), t(v4)), jcolor.yuv444_to_hsv(
        j(y), j(u4), j(v4)))
    _eq(tcolor.i420_to_rgb(t(y), t(u2), t(v2)), jcolor.i420_to_rgb(
        j(y), j(u2), j(v2)))
    _eq(tcolor.i422_to_rgb(t(y), t(uh), t(vh)), jcolor.i422_to_rgb(
        j(y), j(uh), j(vh)))
    for chroma in (uv, uv.reshape(h // 2, w)):
        _eq(tcolor.nv12_to_rgb(t(y), t(chroma)), jcolor.nv12_to_rgb(
            j(y), j(chroma)))
        _eq(tcolor.nv21_to_rgb(t(y), t(chroma)), jcolor.nv21_to_rgb(
            j(y), j(chroma)))
    for p in (packed, packed.reshape(h, w // 2, 4)):
        _eq(tcolor.yuyv_to_rgb(t(p)), jcolor.yuyv_to_rgb(j(p)))
        _eq(tcolor.uyvy_to_rgb(t(p)), jcolor.uyvy_to_rgb(j(p)))


def test_rgb565_both_ways_and_endianness():
    rs = np.random.default_rng(4)
    words = rs.integers(0, 65536, (16, 20), dtype=np.int64).astype(np.uint16)
    words[0, :4] = [0, 65535, 0xF800, 0x07E0]
    _eq(tcolor.rgb565_to_rgb(torch.from_numpy(words)),
        jcolor.rgb565_to_rgb(jnp.asarray(words)))
    pairs = rs.integers(0, 256, (16, 40), dtype=np.uint8)
    for le in (True, False):
        _eq(tcolor.rgb565_to_rgb(torch.from_numpy(pairs), le),
            jcolor.rgb565_to_rgb(jnp.asarray(pairs), le))
    packed = tcolor.rgb_to_rgb565(torch.from_numpy(_rgb(5)))
    assert packed.dtype == torch.uint16
    _eq(tcolor.rgb565_to_rgb(packed), jcolor.rgb565_to_rgb(
        jcolor.rgb_to_rgb565(jnp.asarray(_rgb(5)))))


# ---------------------------------------------------------------- goldens

def test_md5_goldens():
    """md5_rgb_to_hsv, md5_integral, md5_erode_3x3, md5_dilate_3x3 of
    scripts/make_goldens.py:56-65, computed by the port alone."""
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        gold = json.load(f)
    gray = torch.from_numpy(make_test_image())
    rgb = torch.from_numpy(make_test_rgb())
    binary = tthr.threshold_otsu(gray)[0]
    assert exact_hash(tcolor.rgb_to_hsv(rgb)) == gold["md5_rgb_to_hsv"]
    assert exact_hash(tint.integral(gray).to(torch.int64)) == gold[
        "md5_integral"]
    assert exact_hash(tmorph.erode(binary)) == gold["md5_erode_3x3"]
    assert exact_hash(tmorph.dilate(binary)) == gold["md5_dilate_3x3"]


# ---------------------------------------------------------------- integral

def test_integral_tables():
    rs = np.random.default_rng(6)
    u8 = rs.integers(0, 256, (2, 33, 47), dtype=np.uint8)
    got = tint.integral(torch.from_numpy(u8))
    assert got.dtype == torch.int32
    _eq(got, jint.integral(jnp.asarray(u8)))
    i16 = rs.integers(-3000, 3000, (33, 47)).astype(np.int16)
    _eq(tint.integral(torch.from_numpy(i16)), jint.integral(jnp.asarray(i16)))
    f = rs.normal(0, 40, (33, 47)).astype(np.float32)
    _rel(tint.integral(torch.from_numpy(f)), jint.integral(jnp.asarray(f)),
         1e-6)
    _rel(tint.integral(torch.from_numpy(u8[0]), torch.float32),
         jint.integral(jnp.asarray(u8[0]), jnp.float32), 1e-6)
    mask = u8[0] > 128                  # bool: a float32 table, as jnp's
    _eq(tint.integral(torch.from_numpy(mask)), jint.integral(
        jnp.asarray(mask)))
    sq = tint.integral_squared(torch.from_numpy(u8[1]))
    assert sq.dtype == torch.float32
    _rel(sq, jint.integral_squared(jnp.asarray(u8[1])), 1e-6)
    ii = tint.integral(torch.from_numpy(u8[0]))
    for size in (1, 4, 7):
        _eq(tint.box_sum(ii, size), jint.box_sum(
            jint.integral(jnp.asarray(u8[0])), size))


def test_integral_squared_scene_within_1e6():
    """The bench scene's crop of 180 x 640: float32 prefix sums of values
    up to 65,025 pass 2^24, and the two packages round them in another
    order."""
    from tests.fixtures import make_test_image as scene_like
    img = scene_like(180, 640)
    _rel(tint.integral_squared(torch.from_numpy(img)),
         jint.integral_squared(jnp.asarray(img)), 1e-6)


@pytest.mark.parametrize("size", [1, 3, 15, 41])
def test_box_mean_var_int_path_exact(size):
    rs = np.random.default_rng(7)
    img = rs.integers(0, 256, (45, 61), dtype=np.uint8)
    img[:10, :10] = 0
    img[-5:, -7:] = 255
    (m, v), (jm, jv) = tint.box_mean_var(torch.from_numpy(img), size), \
        jint.box_mean_var(jnp.asarray(img), size)
    _eq(m, jm)
    _eq(v, jv)


def test_box_mean_var_float_path():
    """W * size * 16384 >= 2^31 takes the float32 prefix sums."""
    img = np.random.default_rng(8).integers(0, 256, (6, 16400),
                                            dtype=np.uint8)
    (m, v), (jm, jv) = tint.box_mean_var(torch.from_numpy(img), 9), \
        jint.box_mean_var(jnp.asarray(img), 9)
    _rel(m, jm, 1e-5)
    _rel(v, jv, 1e-3)


# ---------------------------------------------------------------- histogram

def test_lut_equalize_projections():
    rs = np.random.default_rng(9)
    img = rs.integers(0, 256, (31, 45), dtype=np.uint8)
    img[:5] = 7
    lut = rs.normal(0, 100, 256).astype(np.float32)
    _eq(thist.apply_lut256(torch.from_numpy(img), torch.from_numpy(lut)),
        jhist.apply_lut256(jnp.asarray(img), jnp.asarray(lut)))
    _eq(thist.equalize(torch.from_numpy(img)), jhist.equalize(
        jnp.asarray(img)))
    batch = rs.integers(0, 120, (2, 3, 17, 23), dtype=np.uint8)
    _eq(thist.equalize(torch.from_numpy(batch)), jhist.equalize(
        jnp.asarray(batch)))
    for name in ("projection_x", "projection_y"):
        _eq(getattr(thist, name)(torch.from_numpy(batch)),
            getattr(jhist, name)(jnp.asarray(batch)))


def test_equalize_rounds_half_to_even():
    """8 x 255 pixels: cdf * 255 / 2040 lands on k + 0.5 for odd cdf / 8."""
    img = np.repeat(np.arange(255, dtype=np.uint8), 8).reshape(8, 255)
    _eq(thist.equalize(torch.from_numpy(img)), jhist.equalize(
        jnp.asarray(img)))


# ---------------------------------------------------------------- threshold

@pytest.mark.parametrize("block,delta,inverse", [(5, 21, False), (3, 8, True),
                                                 (9, -4.5, False)])
def test_threshold_adaptive_bit_exact(block, delta, inverse):
    img = make_test_image(64, 96)
    got = tthr.threshold_adaptive(torch.from_numpy(img), block, delta,
                                  inverse=inverse)
    want = np.asarray(jthr.threshold_adaptive(jnp.asarray(img), block, delta,
                                              inverse=inverse))
    assert int((got.numpy() != want).sum()) == 0
    _eq(got, want)


@pytest.mark.parametrize("block,k", [(41, 0.5), (15, 0.2)])
def test_threshold_wolf_bit_exact(block, k):
    img = make_test_image(72, 100)
    _eq(tthr.threshold_wolf(torch.from_numpy(img), block, k),
        jthr.threshold_wolf(jnp.asarray(img), block, k))


# ---------------------------------------------------------------- morph

def test_strel_is_a_copy():
    for shape in ("cross", "rect"):
        for size in (1, 3, 5, 7):
            np.testing.assert_array_equal(tmorph.strel(shape, size),
                                          jmorph.strel(shape, size))
    with pytest.raises(ValueError):
        tmorph.strel("disk")


@pytest.mark.parametrize("op", ["erode", "dilate", "open_", "close_",
                                "morph_gradient", "top_hat", "black_hat"])
@pytest.mark.parametrize("se", [None, ("rect", 3), ("cross", 5),
                                ("rect", 5)], ids=str)
def test_morphology_bit_exact(op, se):
    rs = np.random.default_rng(10)
    gray = rs.integers(0, 256, (23, 37), dtype=np.uint8)
    binary = (rs.random((23, 37)) < 0.5).astype(np.uint8) * 255
    s = None if se is None else jmorph.strel(*se)
    for img in (gray, binary):
        _eq(getattr(tmorph, op)(torch.from_numpy(img), s),
            getattr(jmorph, op)(jnp.asarray(img), s))


def test_morphology_float_int16_and_bool_pads():
    rs = np.random.default_rng(11)
    f = rs.normal(0, 50, (2, 13, 17)).astype(np.float32)
    i16 = rs.integers(-500, 500, (13, 17)).astype(np.int16)
    for op in ("erode", "dilate", "close_"):
        for img in (f, i16, f > 0):
            _eq(getattr(tmorph, op)(torch.from_numpy(img)),
                getattr(jmorph, op)(jnp.asarray(img)))
