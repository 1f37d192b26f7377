"""Port parity of the generic RANSAC and fitting layer (``calib/ransac.py``,
``math/distance.py``, ``math/fit.py``) and of the slice-1/2 leftovers of
``ops/threefry.py`` (``normal``), ``math/stats.py``, ``core/golden.py`` and
``ops/bitops.py`` against ``compv_tpu`` on the same numpy inputs (CPU).

Tolerances, each with its reason:
* RANSAC sample indices, inlier sets and counts, popcount, Hamming, the
  bit ops, ``exact_hash``, ``keypoint_summary``: exact (integer results;
  the samples come from the same threefry stream and the same stable
  top-k);
* ``threefry.normal``: its uniforms bit-exact; the normals within 4 ulp
  (XLA:CPU evaluates ``log1p`` and ``sqrt`` inside ``erf_inv`` with its own
  approximations);
* line and parabola models: 1e-4 relative to the largest coefficient (the
  same f32 formulas; a 2 x 2 eigh and a least-squares solve of two
  LAPACK drivers); the line up to sign (an eigenvector's sign is the
  solver's, in both packages);
* masked statistics and L2: 1e-6 relative (f32 sums in another order).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.core import golden as jgolden
from compv_tpu.math import distance as jdist
from compv_tpu.math import fit as jfit
from compv_tpu.math import stats as jstats
from compv_tpu.ops import bitops as jbits
from compv_tpu_torch.core import golden as tgolden
from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.interop import config_from_reference, result_from_numpy
from compv_tpu_torch.math import distance as tdist
from compv_tpu_torch.math import fit as tfit
from compv_tpu_torch.math import stats as tstats
from compv_tpu_torch.ops import bitops as tbits
from compv_tpu_torch.ops import threefry

# the modules: each package exports its function under the same name
jransac = importlib.import_module("compv_tpu.calib.ransac")
transac = importlib.import_module("compv_tpu_torch.calib.ransac")


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


def _line_pts(seed=3, n=150, outliers=40):
    rs = np.random.default_rng(seed)
    x = rs.uniform(0, 100, n)
    y = -0.5 * x + 20 + rs.normal(0, 0.2, n)
    y[:outliers] = rs.uniform(-50, 100, outliers)
    return np.stack([x, y], 1).astype(np.float32)


def _parabola_pts(seed=4, n=200, outliers=50):
    rs = np.random.default_rng(seed)
    x = rs.uniform(-10, 10, n)
    y = 0.3 * x ** 2 - 2 * x + 5 + rs.normal(0, 0.1, n)
    y[:outliers] = rs.uniform(0, 60, outliers)
    return np.stack([x, y], 1).astype(np.float32)


# ---------------------------------------------------------------- threefry

@pytest.mark.parametrize("seed,shape", [(0, (31, 64)), (3, (1000,)),
                                        (7, (200, 200))])
def test_threefry_normal(seed, shape):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(key, shape))
    got = threefry.normal(threefry.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, int(ulp.max())
    # the uniforms the normals come from are the reference's, bit for bit
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u_want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    bits = threefry.key_bits(threefry.prng_key(seed), shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u_got = (f * 2.0 + float(lo)).clamp_min(float(lo)).numpy()
    np.testing.assert_array_equal(u_got.view(np.uint32),
                                  u_want.view(np.uint32))


def test_threefry_normal_moments():
    z = threefry.normal(threefry.prng_key(11), (200_000,)).double()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert bool(torch.isfinite(z).all())


# ---------------------------------------------------------------- stats

@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_masked_mean_variance(axis):
    rs = np.random.default_rng(1)
    x = rs.normal(0, 3, (40, 40)).astype(np.float32)
    m = rs.random((40, 40)) < 0.6
    for jf, tf in ((jstats.masked_mean, tstats.masked_mean),
                   (jstats.masked_variance, tstats.masked_variance)):
        if jf is jstats.masked_variance and axis in (1, -1):
            # the reference broadcasts the mean without the reduced axis;
            # with a square x along the last axis that pairs rows with
            # columns, so hold the port to numpy instead
            mu = (x * m).sum(axis, keepdims=True) / m.sum(axis, keepdims=True)
            want = (((x - mu) ** 2) * m).sum(axis) / m.sum(axis)
        else:
            want = np.asarray(jf(jnp.asarray(x), jnp.asarray(m), axis))
        got = tf(_t(x), _t(m, torch.bool), axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mse_2d():
    rs = np.random.default_rng(2)
    a = rs.normal(0, 5, (64, 2)).astype(np.float32)
    b = rs.normal(0, 5, (64, 2)).astype(np.float32)
    m = rs.random(64) < 0.7
    want = float(jstats.mse_2d(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m)))
    got = float(tstats.mse_2d(_t(a), _t(b), _t(m, torch.bool)))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------- golden

def test_golden_copies_equal_originals():
    rs = np.random.default_rng(3)
    n = 50
    kp = {"x": rs.uniform(0, 100, n).astype(np.float32),
          "y": rs.uniform(0, 80, n).astype(np.float32),
          "strength": rs.uniform(0, 60, n).astype(np.float32),
          "valid": rs.random(n) < 0.7}
    jkp = type("KP", (), {k: jnp.asarray(v) for k, v in kp.items()})
    tkp = Keypoints(
        x=_t(kp["x"]), y=_t(kp["y"]), strength=_t(kp["strength"]),
        level=torch.zeros(n, dtype=torch.int32),
        orientation=torch.zeros(n), size=torch.zeros(n),
        valid=_t(kp["valid"], torch.bool))
    assert tgolden.keypoint_summary(tkp) == jgolden.keypoint_summary(jkp)
    for arr in (rs.integers(0, 256, (17, 23), dtype=np.uint8),
                rs.integers(-5, 5, (9,), dtype=np.int32),
                np.asfortranarray(rs.integers(0, 9, (4, 6), dtype=np.int16))):
        assert tgolden.exact_hash(arr) == jgolden.exact_hash(arr)
        assert tgolden.exact_hash(torch.from_numpy(np.ascontiguousarray(
            arr))) == jgolden.exact_hash(arr)
    a = rs.normal(0, 1, 10)
    tgolden.assert_allclose(torch.from_numpy(a), a + 1e-7)
    with pytest.raises(AssertionError):
        tgolden.assert_allclose(a, a + 1e-3, err_msg="far")
    with pytest.raises(AssertionError):
        jgolden.assert_allclose(a, a + 1e-3, err_msg="far")


# ---------------------------------------------------------------- bit ops

def test_bitops_bit_exact():
    rs = np.random.default_rng(4)
    a = rs.integers(0, 256, (33, 32), dtype=np.uint8)
    b = rs.integers(0, 256, (33, 32), dtype=np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tbits.popcount_bytes(ta).numpy(),
                                  np.asarray(jbits.popcount_bytes(a)))
    assert tbits.popcount_bytes(ta).dtype == torch.int32
    for name in ("bits_and", "bits_or", "bits_xor"):
        np.testing.assert_array_equal(
            getattr(tbits, name)(ta, tb).numpy(),
            np.asarray(getattr(jbits, name)(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(tbits.bits_not(ta).numpy(),
                                  np.asarray(jbits.bits_not(jnp.asarray(a))))


# ---------------------------------------------------------------- distance

def test_hamming_exact():
    rs = np.random.default_rng(2)
    data = rs.integers(0, 256, (10, 32), dtype=np.uint8)
    patch = rs.integers(0, 256, 32, dtype=np.uint8)
    got = tdist.hamming_packed(torch.from_numpy(data), torch.from_numpy(patch))
    want = [bin(int.from_bytes((d ^ patch).tobytes(), "little")).count("1")
            for d in data]
    np.testing.assert_array_equal(got.numpy(), want)
    bits = rs.integers(0, 2, (12, 256), dtype=np.uint8)
    pb = rs.integers(0, 2, 256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tdist.hamming(torch.from_numpy(bits), torch.from_numpy(pb)).numpy(),
        np.asarray(jdist.hamming(jnp.asarray(bits), jnp.asarray(pb))))


def test_curve_distances_and_l2():
    rs = np.random.default_rng(5)
    pts = rs.normal(0, 10, (64, 2)).astype(np.float32)
    for abc in ((0.6, 0.8, -2.0), (0.0, 0.0, 1.0)):
        np.testing.assert_allclose(
            tdist.dist_line(_t(pts), *abc).numpy(),
            np.asarray(jdist.dist_line(jnp.asarray(pts), *abc)), rtol=1e-6)
    for axis in ("x", "y"):
        np.testing.assert_allclose(
            tdist.dist_parabola(_t(pts), 0.3, -2.0, 5.0, axis).numpy(),
            np.asarray(jdist.dist_parabola(jnp.asarray(pts), 0.3, -2.0, 5.0,
                                           axis)), rtol=1e-6, atol=1e-5)
    a = rs.normal(0, 1, (6, 4)).astype(np.float32)
    b = rs.normal(0, 1, (5, 4)).astype(np.float32)
    for jf, tf in ((jdist.squared_l2, tdist.squared_l2), (jdist.l2, tdist.l2)):
        np.testing.assert_allclose(tf(_t(a), _t(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(a),
                                                 jnp.asarray(b))),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- ransac

def _jline(sub):
    p, q = sub[0], sub[1]
    d = q - p
    nvec = jnp.stack([-d[1], d[0]])
    nvec = nvec / jnp.maximum(jnp.linalg.norm(nvec), 1e-9)
    return jnp.concatenate([nvec, -jnp.dot(nvec, p)[None]])


def _tline(sub):
    p, q = sub[0], sub[1]
    d = q - p
    nvec = torch.stack([-d[1], d[0]])
    nvec = nvec / torch.linalg.vector_norm(nvec).clamp_min(1e-9)
    return torch.cat([nvec, -(nvec * p).sum()[None]])


def _jres(m, p):
    return jnp.abs(p @ m[:2] + m[2])


def _tres(m, p):
    return (p @ m[:2] + m[2]).abs()


@pytest.mark.parametrize("seed,valid", [(0, None), (5, "half")])
def test_ransac_samples_bit_exact(seed, valid):
    """The sample indices of every hypothesis equal the reference's."""
    rs = np.random.default_rng(seed)
    n = 300
    mask = np.ones(n, bool) if valid is None else rs.random(n) < 0.5
    cfg = jransac.RansacConfig(num_hypotheses=128, min_model_points=3,
                               seed=seed)
    u = jax.random.uniform(jax.random.PRNGKey(seed), (128, n))
    u = jnp.where(jnp.asarray(mask)[None, :], u, -1.0)
    want = np.asarray(jax.lax.top_k(u, 3)[1])
    tcfg = config_from_reference(cfg)
    got = transac._masked_sample_idx(tcfg.seed, _t(mask, torch.bool),
                                     tcfg.num_hypotheses,
                                     tcfg.min_model_points)
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(len(set(r)) == 3 for r in got.tolist())


def test_ransac_line_equals_reference():
    pts = _line_pts(seed=7, n=200, outliers=60)
    cfg = jransac.RansacConfig(num_hypotheses=256, min_model_points=2,
                               threshold=1.0)
    want = jransac.ransac(jnp.asarray(pts), _jline, _jres, config=cfg)
    got = transac.ransac(_t(pts), _tline, _tres,
                         config=config_from_reference(cfg))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 120
    np.testing.assert_allclose(got.model.numpy(), np.asarray(want.model),
                               rtol=1e-4, atol=1e-4)
    slope = -float(got.model[0]) / float(got.model[1])
    assert abs(slope - (-0.5)) < 0.05


def test_ransac_two_valid_points():
    """Two valid points out of 50: the exact line through them."""
    pts = np.zeros((50, 2), np.float32)
    pts[0] = [0, 5]
    pts[1] = [10, 5]
    mask = np.zeros(50, bool)
    mask[:2] = True
    res = transac.ransac(_t(pts), _tline, _tres, _t(mask, torch.bool),
                         transac.RansacConfig(num_hypotheses=32,
                                              min_model_points=2,
                                              threshold=0.5))
    assert int(res.num_inliers) == 2


def test_ransac_tuple_model():
    """A model of several tensors comes back row by row (the reference's
    tree_map of the best hypothesis)."""
    pts = _line_pts()

    def build(sub):
        m = _tline(sub)
        return {"normal": m[:2], "c": (m[2], m[2] * 2)}

    res = transac.ransac(_t(pts), build,
                         lambda m, p: (p @ m["normal"] + m["c"][0]).abs())
    plain = transac.ransac(_t(pts), _tline, _tres)
    assert torch.equal(res.model["normal"], plain.model[:2])
    assert torch.equal(res.model["c"][1], plain.model[2] * 2)
    assert torch.equal(res.inliers, plain.inliers)


# ---------------------------------------------------------------- fits

def _same_line(got, want):
    got, want = np.asarray(got), np.asarray(want)
    if np.dot(got[:2], want[:2]) < 0:
        got = -got
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed,threshold", [(3, 1.0), (8, 0.5)])
def test_fit_line_equals_reference(seed, threshold):
    pts = _line_pts(seed)
    want = jfit.fit_line(jnp.asarray(pts), threshold=threshold)
    got = tfit.fit_line(_t(pts), threshold=threshold)
    _same_line(got.abc, want.abc)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    a, b, _ = got.abc.tolist()
    assert abs(-a / b - (-0.5)) < 0.03
    back = result_from_numpy(tfit.LineFit, want)
    assert torch.equal(back.inliers, got.inliers)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_fit_parabola_equals_reference(axis):
    pts = _parabola_pts()
    if axis == "y":
        pts = pts[:, ::-1].copy()
    want = jfit.fit_parabola(jnp.asarray(pts), threshold=0.8, axis=axis)
    got = tfit.fit_parabola(_t(pts), threshold=0.8, axis=axis)
    w = np.asarray(want.abc)
    np.testing.assert_allclose(got.abc.numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    a, b, _ = got.abc.tolist()
    assert abs(a - 0.3) < 0.03 and abs(b + 2) < 0.2
    back = result_from_numpy(tfit.ParabolaFit, want)
    assert int(back.num_inliers) == int(got.num_inliers)


def test_fit_parabola_integer_x_equals_reference():
    """Pixel coordinates: 1,000 points over 200 integer x, so some
    3-point samples share an x and their Vandermonde matrix is singular.
    Such a hypothesis loses in both packages; the port does not raise."""
    rs = np.random.default_rng(11)
    x = rs.integers(-100, 100, 1000).astype(np.float64)
    y = 0.01 * x ** 2 - 0.5 * x + 3 + rs.normal(0, 0.1, x.size)
    y[:300] = rs.uniform(-20, 150, 300)
    pts = np.stack([x, y], 1).astype(np.float32)
    idx = transac._masked_sample_idx(0, torch.ones(1000, dtype=torch.bool),
                                     256, 3).numpy()
    xs = np.sort(x[idx], axis=1)
    assert (np.diff(xs, axis=1) == 0).any(axis=1).sum() >= 1
    want = jfit.fit_parabola(jnp.asarray(pts), threshold=0.8)
    got = tfit.fit_parabola(_t(pts), threshold=0.8)
    w = np.asarray(want.abc)
    np.testing.assert_allclose(got.abc.numpy(), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert abs(float(got.abc[0]) - 0.01) < 1e-3


def test_fit_line_masked():
    """Masked-out points never count, in either package."""
    pts = _line_pts(seed=9)
    mask = np.arange(len(pts)) % 3 != 0
    want = jfit.fit_line(jnp.asarray(pts), jnp.asarray(mask))
    got = tfit.fit_line(_t(pts), _t(mask, torch.bool))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert not bool(got.inliers[~_t(mask, torch.bool)].any())
