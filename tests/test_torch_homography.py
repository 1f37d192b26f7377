"""Port parity, rows 4 (as RANSAC uses it), 14 and 15 of the slice:
``math/stats.py``, ``math/transform.py`` and ``calib/homography.py``
against ``compv_tpu`` on the same numpy inputs (CPU), and the locked
homography goldens.

Tolerances, each with its reason:
* DLT rows, 3x3 adjugate inverses, Hartley normalization, point
  transforms, transfer errors, sample indices, degeneracy flags, inlier
  masks and counts: exact (the same f32 operations in the same order, the
  same threefry stream; the issue allowed 1e-6 relative where sums could
  reorder, and the run showed none);
* homographies: max |dH| / |H| <= 1e-4 (the 9x9 eigh and the batched 3x3
  products go through another LAPACK / BLAS than XLA:CPU's; measured
  2.6e-5 to 3.5e-5).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.calib import homography as jh
from compv_tpu.core.golden import quantized_hash
from compv_tpu.math import stats as jstats
from compv_tpu.math import transform as jtransform
from compv_tpu_torch.calib import homography as th
from compv_tpu_torch.interop import config_from_reference
from compv_tpu_torch.math import stats, transform

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _golden_set():
    """The correspondence set of scripts/make_goldens.py:70-79."""
    rs = np.random.default_rng(11)
    src = rs.uniform(20, 400, (200, 2)).astype(np.float32)
    h_true = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0],
                       [1e-4, -8e-5, 1.0]], np.float32)
    p = np.concatenate([src, np.ones((200, 1), np.float32)], 1) @ h_true.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    dst[150:] += rs.uniform(40, 90, (50, 2)).astype(np.float32)
    return src, dst


@pytest.fixture(scope="module")
def points():
    rs = np.random.default_rng(21)
    src = rs.uniform(0, 300, (64, 2)).astype(np.float32)
    dst = (src * 1.1 + [5.0, -3.0] + rs.normal(0, 0.5, src.shape)).astype(np.float32)
    mask = rs.random(64) < 0.8
    return src, dst, mask


def test_hartley_normalize(points):
    src, _, mask = points
    want_p, want_t = jstats.hartley_normalize(jnp.asarray(src), jnp.asarray(mask))
    got_p, got_t = stats.hartley_normalize(torch.from_numpy(src),
                                           torch.from_numpy(mask))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_apply_homography():
    rs = np.random.default_rng(22)
    h = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0], [1e-5, 2e-5, 1.0]],
                 np.float32)
    pts = rs.uniform(0, 500, (40, 2)).astype(np.float32)
    want = jtransform.apply_homography(jnp.asarray(h), jnp.asarray(pts))
    got = transform.apply_homography(torch.from_numpy(h), torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dlt_rows_exact(points):
    src, dst, _ = points
    np.testing.assert_array_equal(
        th._dlt_rows(torch.from_numpy(src), torch.from_numpy(dst)).numpy(),
        np.asarray(jh._dlt_rows(jnp.asarray(src), jnp.asarray(dst))))


def test_inv3x3_exact():
    m = np.random.default_rng(23).normal(0, 1, (16, 3, 3)).astype(np.float32)
    m[0] = 0.0  # singular: inf determinant guard
    np.testing.assert_array_equal(th._inv3x3(torch.from_numpy(m)).numpy(),
                                  np.asarray(jh._inv3x3(jnp.asarray(m))))


def test_compute_homography_dlt(points):
    src, dst, mask = points
    want = jh.compute_homography_dlt(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(mask))
    got = th.compute_homography_dlt(torch.from_numpy(src), torch.from_numpy(dst),
                                    torch.from_numpy(mask))
    assert _rel(got.numpy(), want) <= 1e-4


def test_h_from_quad_batched():
    rs = np.random.default_rng(24)
    s4 = rs.uniform(0, 400, (32, 4, 2)).astype(np.float32)
    d4 = (s4 + rs.normal(0, 5, s4.shape)).astype(np.float32)
    want = np.asarray(jax.vmap(jh._h_from_quad)(jnp.asarray(s4), jnp.asarray(d4)))
    got = th._h_from_quad(torch.from_numpy(s4), torch.from_numpy(d4)).numpy()
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def test_symmetric_transfer_error(points):
    src, dst, _ = points
    h = np.array([[1.1, 0.0, 5.0], [0.0, 1.1, -3.0], [0.0, 0.0, 1.0]], np.float32)
    want = jh.symmetric_transfer_error(jnp.asarray(h), jnp.asarray(src),
                                       jnp.asarray(dst))
    got = th.symmetric_transfer_error(torch.from_numpy(h), torch.from_numpy(src),
                                      torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,s,n", [(0, 128, 200), (3, 64, 37)])
def test_masked_sample_idx_exact(seed, s, n):
    mask = np.random.default_rng(seed + 100).random(n) < 0.6
    want = jh._masked_sample_idx(jax.random.PRNGKey(seed), jnp.asarray(mask), s, 4)
    got = th._masked_sample_idx(seed, torch.from_numpy(mask), s, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quad_nondegenerate_exact():
    rs = np.random.default_rng(25)
    q = rs.uniform(0, 100, (40, 4, 2)).astype(np.float32)
    q[:10, 2] = (q[:10, 0] + q[:10, 1]) / 2   # three colinear points
    want = jax.vmap(jh._quad_nondegenerate)(jnp.asarray(q))
    got = th._quad_nondegenerate(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[:10].any()


def test_find_homography_goldens():
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        goldens = json.load(f)
    src, dst = _golden_set()
    res = th.find_homography(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.ones(200, dtype=torch.bool),
                             th.HomographyConfig(num_hypotheses=256))
    assert int(res.num_inliers) == goldens["homography_inliers"] == 150
    hm = res.h.numpy() / res.h.numpy()[2, 2]
    assert quantized_hash(hm, decimals=2) == goldens["homography_hash_q2"]


@pytest.mark.parametrize("seed,refine", [(0, True), (5, True), (0, False)])
def test_find_homography_matches_reference(seed, refine):
    src, dst = _golden_set()
    mask = np.ones(200, bool)
    mask[::7] = False
    jcfg = jh.HomographyConfig(num_hypotheses=128, seed=seed, refine=refine)
    want = jh.find_homography(jnp.asarray(src), jnp.asarray(dst),
                              jnp.asarray(mask), jcfg)
    got = th.find_homography(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(mask), config_from_reference(jcfg))
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert _rel(got.h.numpy(), want.h) <= 1e-4
