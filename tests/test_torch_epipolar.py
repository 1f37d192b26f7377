"""Port parity of ``ops/threefry.py``'s ``split`` / ``randint``,
``calib/epipolar.py`` and ``calib/pnp.py`` against ``compv_tpu`` on the
same numpy inputs (CPU), on the scenes of ``tests/test_epipolar.py`` and
``tests/test_sfm.py::TestPnp``.

Tolerances, each with its reason:
* ``split``, ``randint``, sample indices, inlier masks and counts: exact
  (the same threefry words; the inlier tests compare f32 errors against a
  threshold, and no error of these scenes lies within rounding of it);
* E: up to sign (an eigenvector's sign is the solver's choice), 2e-4
  absolute, entries of order 1 (the 9x9 eigh and the 3x3 SVDs of another
  LAPACK than XLA:CPU's; measured up to 1.6e-4);
* R, t: 1e-4 and 2e-4 (rvec and the unit t, from the same E);
* triangulated inliers: 1e-3 relative to the scene's depth (two 4x4 eighs
  per point; outliers triangulate anywhere and are not compared);
* PnP pose: 1e-4 (the DLT's float32 12x12 normal matrix is poorly
  conditioned, and another LAPACK's eigh moves t by up to 5.8e-5 on the
  noise-free scene, against its truth within 2e-4 in both packages; after
  RANSAC the GN polish keeps a step only where the cost falls).
Where hypotheses tie on their inlier count, both packages take the first
(``argmax``); ties between hypotheses whose counts are the same integer
are broken by index alone, so no float enters them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.calib import epipolar as je
from compv_tpu.calib import pnp as jp
from compv_tpu.slam.ba import rodrigues_to_matrix
from compv_tpu_torch.calib import epipolar as te
from compv_tpu_torch.calib import pnp as tp
from compv_tpu_torch.interop import config_from_reference
from compv_tpu_torch.ops import threefry

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- randint

def test_split_equals_jax():
    for seed in (0, 1, 7, 2 ** 31 - 1):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(seed)))).tolist()
        assert [list(k) for k in threefry.split(threefry.prng_key(seed))] \
            == want


@pytest.mark.parametrize("span", [1, 7, 2 ** 16, 2 ** 16 + 3, 123457,
                                  2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(512, 8), (3,), (7, 5)])
def test_randint_bit_exact(span, shape):
    for seed in (0, 3, 12345):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(key, shape, 0, span))
        got = threefry.randint(threefry.prng_key(seed), shape, 0, span)
        np.testing.assert_array_equal(_np(got), want)
        hi = min(span + 5, 2 ** 31 - 1)
        want = np.asarray(jax.random.randint(key, shape, 5, hi))
        got = threefry.randint(threefry.prng_key(seed), shape, 5, hi)
        np.testing.assert_array_equal(_np(got), want)


def test_randint_tensor_maxval_and_empty_span():
    """maxval as a tensor (find_essential's n_valid), and maxval <= minval
    (span 1: every draw is minval)."""
    key = jax.random.PRNGKey(0)
    for n in (1, 9, 117, 512):
        want = np.asarray(jax.random.randint(key, (512, 8), 0,
                                             jnp.maximum(jnp.int32(n), 1)))
        got = threefry.randint((0, 0), (512, 8), 0,
                               torch.tensor(n, dtype=torch.int32))
        np.testing.assert_array_equal(_np(got), want)
    want = np.asarray(jax.random.randint(key, (16,), 4, 2))
    np.testing.assert_array_equal(_np(threefry.randint((0, 0), (16,), 4, 2)),
                                  want)
    assert (want == 4).all()


# ---------------------------------------------------------------- essential

def _two_view(rs, n=120):
    """tests/test_epipolar.py:two_view_scene."""
    pts = rs.uniform(-1, 1, (n, 3)) + [0, 0, 4.0]
    r_true = np.asarray(rodrigues_to_matrix(
        jnp.asarray([0.05, -0.12, 0.03], jnp.float32)))
    t_true = np.array([0.4, 0.05, 0.02])

    def proj(p):
        q = p / p[:, 2:3]
        return q[:, :2] @ np.diag([K[0, 0], K[1, 1]]) + [K[0, 2], K[1, 2]]

    return pts, proj(pts), proj(pts @ r_true.T + t_true)


SCENES = {"clean": (0, 120, 0, 512, 1.0),
          "outliers": (1, 150, 45, 1024, 1.0),
          "masked_noisy": (3, 200, 20, 512, 0.8)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def essential_pair(request):
    seed, n, n_bad, hyp, keep = SCENES[request.param]
    rs = np.random.default_rng(seed)
    pts, p1, p2 = _two_view(rs, n)
    p2 = p2.copy()
    if n_bad:
        bad = rs.choice(n, n_bad, replace=False)
        p2[bad] = rs.uniform(0, 640, (n_bad, 2))
    p2 += rs.normal(0, 0.3 if keep < 1 else 0.0, p2.shape)
    mask = rs.random(n) < keep
    src, dst = p1.astype(np.float32), p2.astype(np.float32)
    cfg = je.EssentialConfig(num_hypotheses=hyp)
    want = je.find_essential(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(K), jnp.asarray(mask), cfg)
    got = te.find_essential(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(K), torch.from_numpy(mask),
                            config_from_reference(cfg))
    return want, got, pts


def test_find_essential_inliers_exact(essential_pair):
    want, got, _ = essential_pair
    np.testing.assert_array_equal(_np(got.inliers), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 80


def test_find_essential_pose(essential_pair):
    want, got, pts = essential_pair
    e_w, e_g = np.asarray(want.e), _np(got.e)
    assert min(np.abs(e_g - e_w).max(), np.abs(e_g + e_w).max()) <= 2e-4
    np.testing.assert_allclose(_np(got.rvec), np.asarray(want.rvec),
                               atol=1e-4)
    np.testing.assert_allclose(_np(got.tvec), np.asarray(want.tvec),
                               atol=2e-4)
    inl = np.asarray(want.inliers)
    np.testing.assert_allclose(_np(got.points3d)[inl],
                               np.asarray(want.points3d)[inl],
                               atol=1e-3 * 4.0)


def test_sample_indices_exact():
    """The 8-point samples of find_essential: the stable argsort of the
    mask and the randint stream, against the reference's own lines."""
    rs = np.random.default_rng(8)
    mask = rs.random(300) < 0.6
    n_valid = int(mask.sum())
    order = jnp.argsort(~jnp.asarray(mask))
    want = np.asarray(order[jax.random.randint(
        jax.random.PRNGKey(0), (512, 8), 0, n_valid)])
    t_mask = torch.from_numpy(mask)
    t_order = torch.argsort((~t_mask).to(torch.int32), stable=True)
    got = t_order[threefry.randint((0, 0), (512, 8), 0,
                                   t_mask.sum().to(torch.int32)).long()]
    np.testing.assert_array_equal(_np(got), want)


def test_eight_point_sampson_triangulate():
    rs = np.random.default_rng(2)
    pts, p1, p2 = _two_view(rs, 40)
    kinv = np.linalg.inv(K)

    def norm(p):
        q = np.concatenate([p, np.ones((len(p), 1))], 1) @ kinv.T
        return (q[:, :2] / q[:, 2:]).astype(np.float32)

    s, d = norm(p1), norm(p2)
    f_w = np.asarray(je.compute_fundamental_8pt(jnp.asarray(s),
                                                jnp.asarray(d)))
    f_g = _np(te.compute_fundamental_8pt(torch.from_numpy(s),
                                         torch.from_numpy(d)))
    f_w, f_g = f_w / np.abs(f_w).max(), f_g / np.abs(f_g).max()
    assert min(np.abs(f_g - f_w).max(), np.abs(f_g + f_w).max()) <= 1e-4
    e = je._essential_from_f(jnp.asarray(f_w))
    np.testing.assert_allclose(
        _np(te.sampson_error(torch.from_numpy(np.asarray(e)),
                             torch.from_numpy(s), torch.from_numpy(d))),
        np.asarray(je.sampson_error(e, jnp.asarray(s), jnp.asarray(d))),
        rtol=1e-5, atol=1e-12)
    r = np.asarray(rodrigues_to_matrix(jnp.asarray([0.05, -0.12, 0.03],
                                                   jnp.float32)))
    t = np.array([0.4, 0.05, 0.02], np.float32)
    want = np.asarray(je.triangulate_points(jnp.asarray(r), jnp.asarray(t),
                                            jnp.asarray(s), jnp.asarray(d)))
    got = _np(te.triangulate_points(torch.from_numpy(r), torch.from_numpy(t),
                                    torch.from_numpy(s), torch.from_numpy(d)))
    np.testing.assert_allclose(got, want, atol=1e-3 * 4.0)
    np.testing.assert_allclose(got, pts, atol=1e-2)


# ---------------------------------------------------------------- pnp

def _pose_scene():
    """tests/test_sfm.py's pose_scene."""
    rs = np.random.default_rng(3)
    k = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]], np.float32)
    rvec = np.array([0.05, -0.1, 0.03])
    tvec = np.array([0.2, -0.1, 0.4])
    pts = (rs.uniform(-2, 2, (64, 3)) + [0, 0, 6.0]).astype(np.float32)
    r = np.asarray(rodrigues_to_matrix(jnp.asarray(rvec, jnp.float32)))
    pc = pts @ r.T + tvec
    px = (pc[:, :2] / pc[:, 2:3]) * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
    return k, rvec, tvec, pts, px.astype(np.float32)


def test_pnp_dlt_exact_scene():
    k, rvec, tvec, pts, px = _pose_scene()
    ph = np.concatenate([px, np.ones((len(px), 1), np.float32)], axis=1)
    pn = (ph @ np.linalg.inv(k).T)[:, :2].astype(np.float32)
    rv_w, tv_w = jp.pnp_dlt(jnp.asarray(pts), jnp.asarray(pn))
    rv_g, tv_g = tp.pnp_dlt(torch.from_numpy(pts), torch.from_numpy(pn))
    np.testing.assert_allclose(_np(rv_g), np.asarray(rv_w), atol=1e-4)
    np.testing.assert_allclose(_np(tv_g), np.asarray(tv_w), atol=1e-4)
    np.testing.assert_allclose(_np(rv_g), rvec, atol=1e-3)


@pytest.mark.parametrize("case", ["outliers", "padded"])
def test_solve_pnp(case):
    k, rvec, tvec, pts, px = _pose_scene()
    rs = np.random.default_rng(4)
    px = px.copy()
    bad = rs.choice(len(px), 20, replace=False)
    px[bad] += rs.uniform(30, 90, (20, 2))
    m = np.ones(len(px), bool)
    if case == "padded":
        pts = np.concatenate([pts, np.zeros((64, 3), np.float32)])
        px = np.concatenate([px, np.zeros((64, 2), np.float32)])
        m = np.concatenate([m, np.zeros(64, bool)])
    cfg = jp.PnpConfig()
    want = jp.solve_pnp(jnp.asarray(pts), jnp.asarray(px), jnp.asarray(k),
                        jnp.asarray(m), cfg)
    idx_w = np.asarray(jax.jit(jp._masked_sample_idx, static_argnums=(2, 3))(
        jax.random.PRNGKey(0), jnp.asarray(m), 256, 6))
    idx_g = _np(tp._masked_sample_idx(0, torch.from_numpy(m), 256, 6))
    np.testing.assert_array_equal(idx_g, idx_w)
    got = tp.solve_pnp(torch.from_numpy(pts), torch.from_numpy(px),
                       torch.from_numpy(k), torch.from_numpy(m),
                       config_from_reference(cfg))
    np.testing.assert_array_equal(_np(got.inliers), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) >= 40
    assert not _np(got.inliers)[bad].any()
    np.testing.assert_allclose(_np(got.rvec), np.asarray(want.rvec),
                               atol=1e-4)
    np.testing.assert_allclose(_np(got.tvec), np.asarray(want.tvec),
                               atol=1e-4)
