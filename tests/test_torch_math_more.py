"""Port parity of ``math/matrix.py``, ``math/ops.py`` and ``math/pca.py``
against ``compv_tpu`` on the same numpy inputs (CPU).

Tolerances, each with its reason:
* saturating and wrapping integer arithmetic, integer casts, ``rank``,
  the predicates, Givens products of exact values, ``fast_atan2_deg``:
  exact (integer arithmetic, or the same f32 operations in the same order
  without a fused multiply-add);
* products, inverses, determinants, eigen- and singular values, the PCA's
  mean, eigenvalues and projections: 1e-5 relative to the largest entry
  (LAPACK's and XLA's f32 kernels sum in other orders);
* eigen-, singular- and principal vectors: up to sign (each solver picks
  its own), then 1e-4;
* ``atan2_deg_exact``: 1e-4 degree (``torch.atan2`` and XLA's ``arctan2``
  may differ by an ulp of the angle);
* image moments: 1e-6 relative (float32 sums over the image in another
  order; the powers are formed as the reference forms them);
* Hu moments: 1e-4 relative (the normalized central moments divide
  differences of such sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.math import matrix as jmat
from compv_tpu.math import ops as jops
from compv_tpu.math import pca as jpca
from compv_tpu_torch.interop import model_from_numpy, model_to_numpy
from compv_tpu_torch.math import matrix as tmat
from compv_tpu_torch.math import ops as tops
from compv_tpu_torch.math import pca as tpca


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


def _close(got, want, rtol=1e-5):
    got = np.asarray(got.detach().cpu() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def _up_to_sign(got, want, axis, atol=1e-4):
    """Columns (axis=0 varies fastest within a vector ... ) compared after
    flipping each vector of ``got`` to the sign of ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    dots = np.sum(got * want, axis=axis, keepdims=True)
    np.testing.assert_allclose(got * np.sign(dots), want, atol=atol)


def _sym(rs, n):
    a = rs.normal(size=(n, n)).astype(np.float32)
    return (a + a.T).astype(np.float32)


# ---------------------------------------------------------------- matrix

def test_products_and_givens():
    rs = np.random.default_rng(0)
    a = rs.normal(size=(7, 5)).astype(np.float32)
    b = rs.normal(size=(5, 6)).astype(np.float32)
    c = rs.normal(size=(4, 5)).astype(np.float32)
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    _close(tmat.mul_ab(ta, tb), jmat.mul_ab(jnp.asarray(a), jnp.asarray(b)))
    _close(tmat.mul_abt(ta, tc), jmat.mul_abt(jnp.asarray(a), jnp.asarray(c)))
    _close(tmat.mul_ata(ta), jmat.mul_ata(jnp.asarray(a)))
    a3 = rs.normal(size=(2, 3, 5)).astype(np.float32)
    _close(tmat.mul_abt(torch.from_numpy(a3), tc),
           jmat.mul_abt(jnp.asarray(a3), jnp.asarray(c)))
    _close(tmat.mul_ata(torch.from_numpy(a3)), jmat.mul_ata(jnp.asarray(a3)))
    ints = rs.integers(-9, 9, (5, 5)).astype(np.float32)
    for fn_t, fn_j in ((tmat.mul_ag, jmat.mul_ag), (tmat.mul_ga, jmat.mul_ga)):
        np.testing.assert_array_equal(
            fn_t(torch.from_numpy(ints), 1, 3, 0.6, 0.8).numpy(),
            np.asarray(fn_j(jnp.asarray(ints), 1, 3, 0.6, 0.8)))
    np.testing.assert_array_equal(tmat.transpose(ta).numpy(),
                                  np.asarray(jmat.transpose(jnp.asarray(a))))
    _close(tmat.trace(torch.from_numpy(ints)),
           jmat.trace(jnp.asarray(ints)))
    _close(tmat.determinant(torch.from_numpy(ints)),
           jmat.determinant(jnp.asarray(ints)))


def test_rank_and_predicates():
    rs = np.random.default_rng(1)
    full = rs.normal(size=(6, 4)).astype(np.float32)
    low = (rs.normal(size=(6, 2)) @ rs.normal(size=(2, 4))).astype(np.float32)
    for m in (full, low):
        assert int(tmat.rank(torch.from_numpy(m))) == int(
            jmat.rank(jnp.asarray(m)))
    assert int(tmat.rank(torch.from_numpy(low))) == 2
    s = _sym(rs, 5)
    ns = s.copy()
    ns[0, 1] += 1e-3
    for m in (s, ns):
        assert bool(tmat.is_symmetric(torch.from_numpy(m))) == bool(
            jmat.is_symmetric(jnp.asarray(m)))
    line = np.stack([np.arange(6.0), 2 * np.arange(6.0) + 1], 1)
    bent = line.copy()
    bent[3, 1] += 0.5
    for p in (line, bent):
        p = p.astype(np.float32)
        assert bool(tmat.is_colinear_2d(torch.from_numpy(p))) == bool(
            jmat.is_colinear_2d(jnp.asarray(p)))
    assert bool(tmat.is_colinear_2d(torch.from_numpy(
        line.astype(np.float32))))


def test_eigen_svd_pseudo_inverse():
    rs = np.random.default_rng(2)
    s = _sym(rs, 6)
    vals, vecs = tmat.eigen_symm(torch.from_numpy(s))
    jvals, jvecs = jmat.eigen_symm(jnp.asarray(s))
    _close(vals, jvals)
    assert np.all(np.diff(vals.numpy()) <= 0)
    _up_to_sign(vecs.numpy(), np.asarray(jvecs), axis=0)
    a = rs.normal(size=(7, 4)).astype(np.float32)
    u, sv, vt = tmat.svd(torch.from_numpy(a))
    ju, jsv, jvt = jmat.svd(jnp.asarray(a))
    _close(sv, jsv)
    _up_to_sign(u.numpy(), np.asarray(ju), axis=0)
    _up_to_sign(vt.numpy(), np.asarray(jvt), axis=1)
    low = (rs.normal(size=(5, 2)) @ rs.normal(size=(2, 4))).astype(np.float32)
    for m in (a, low):
        _close(tmat.pseudo_inverse(torch.from_numpy(m)),
               jmat.pseudo_inverse(jnp.asarray(m)), 1e-4)


def test_inverses_regular_singular_and_batched():
    rs = np.random.default_rng(3)
    reg = rs.normal(size=(3, 3)).astype(np.float32)
    sing = np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], np.float32)
    zero = np.zeros((3, 3), np.float32)
    for m in (reg, sing, zero):
        _close(tmat.inverse_3x3(torch.from_numpy(m)),
               jmat.inverse_3x3(jnp.asarray(m)), 1e-4)
    batch = np.stack([reg, sing, zero, np.eye(3, dtype=np.float32)])
    got = tmat.inverse_3x3(torch.from_numpy(batch))
    for i, m in enumerate(batch):
        _close(got[i], jmat.inverse_3x3(jnp.asarray(m)), 1e-4)
    pinv = tmat.pseudo_inverse(torch.from_numpy(batch))
    for i, m in enumerate(batch):
        _close(pinv[i], jmat.pseudo_inverse(jnp.asarray(m)), 1e-4)
    d = np.diag([2.0, 0.0, -4.0, 1e-13]).astype(np.float32)
    np.testing.assert_array_equal(
        tmat.inverse_diagonal(torch.from_numpy(d)).numpy(),
        np.asarray(jmat.inverse_diagonal(jnp.asarray(d))))
    got = tmat.inverse_diagonal(torch.from_numpy(np.stack([d, 2 * d])))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(
        jmat.inverse_diagonal(jnp.asarray(2 * d))))


# ---------------------------------------------------------------- ops

_EDGES = {
    np.uint8: [0, 1, 2, 127, 128, 254, 255],
    np.int8: [-128, -127, -1, 0, 1, 126, 127],
    np.int16: [-32768, -32767, -1, 0, 1, 255, 32766, 32767],
    np.uint16: [0, 1, 255, 256, 32768, 65534, 65535],
    np.int32: [-2 ** 31, -2 ** 31 + 1, -65536, -1, 0, 1, 65535,
               2 ** 31 - 2, 2 ** 31 - 1],
    np.uint32: [0, 1, 65535, 65536, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2,
                2 ** 32 - 1],
}


@pytest.mark.parametrize("dtype", list(_EDGES), ids=lambda d: d.__name__)
@pytest.mark.parametrize("op", ["add", "sub", "mul_elementwise"])
def test_integer_ops_saturate_and_wrap_bit_exact(op, dtype):
    """Every pair of edge values, plus random values: <= 16-bit dtypes
    saturate, 32-bit ones wrap."""
    e = np.array(_EDGES[dtype], dtype)
    a, b = (v.reshape(-1) for v in np.meshgrid(e, e))
    info = np.iinfo(dtype)
    rs = np.random.default_rng(4)
    ra = rs.integers(info.min, int(info.max) + 1, 64, dtype=np.int64)
    rb = rs.integers(info.min, int(info.max) + 1, 64, dtype=np.int64)
    a = np.concatenate([a, ra.astype(dtype)])
    b = np.concatenate([b, rb.astype(dtype)])
    got = getattr(tops, op)(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(getattr(jops, op)(jnp.asarray(a), jnp.asarray(b)))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # a Python scalar operand
    got = getattr(tops, op)(torch.from_numpy(a), 3)
    want = np.asarray(getattr(jops, op)(jnp.asarray(a), 3))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("target", [(np.uint8, torch.uint8),
                                    (np.int16, torch.int16),
                                    (np.int32, torch.int32)],
                         ids=["u8", "i16", "i32"])
def test_cast_saturates_and_rounds_half_even(target):
    v = np.array([-3e9, -2 ** 31, -40000.5, -129.5, -0.5, 0.5, 1.5, 2.5,
                  127.5, 254.5, 255.5, 256.0, 32767.5, 40000.4, 2 ** 31,
                  3e9], np.float32)
    got = tops.cast(torch.from_numpy(v), target[1])
    want = np.asarray(jops.cast(jnp.asarray(v), target[0]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_ops_activations_and_hypot():
    rs = np.random.default_rng(5)
    a = rs.normal(0, 3, (64,)).astype(np.float32)
    b = rs.normal(0, 3, (64,)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("add", "sub", "mul_elementwise"):
        np.testing.assert_array_equal(getattr(tops, name)(ta, tb).numpy(),
                                      np.asarray(getattr(jops, name)(ja, jb)))
    np.testing.assert_array_equal(tops.abs_(ta).numpy(), np.asarray(
        jops.abs_(ja)))
    np.testing.assert_array_equal(tops.relu(ta).numpy(), np.asarray(
        jops.relu(ja)))
    np.testing.assert_array_equal(tops.clip(ta, -1.0, 2.0).numpy(),
                                  np.asarray(jops.clip(ja, -1.0, 2.0)))
    np.testing.assert_array_equal(tops.scale_values(ta, 0.5).numpy(),
                                  np.asarray(jops.scale_values(ja, 0.5)))
    lo, hi = tops.minmax(ta)
    jlo, jhi = jops.minmax(ja)
    assert float(lo) == float(jlo) and float(hi) == float(jhi)
    for name in ("tanh_activation", "logistic_activation", "fast_exp"):
        _close(getattr(tops, name)(ta), getattr(jops, name)(ja), 1e-6)
    _close(tops.hypot_(ta, tb), jops.hypot_(ja, jb), 1e-6)
    u8 = torch.from_numpy(np.array([10, 250], np.uint8))
    np.testing.assert_array_equal(tops.clip(u8, 20, 240).numpy(), np.asarray(
        jops.clip(jnp.asarray(np.array([10, 250], np.uint8)), 20, 240)))


def test_atan2_fast_and_exact():
    rs = np.random.default_rng(6)
    y = rs.normal(0, 50, 4096).astype(np.float32)
    x = rs.normal(0, 50, 4096).astype(np.float32)
    axes = np.array([0, 0, 1, -1, 0, 3, -3, 5, -5], np.float32)
    y = np.concatenate([y, axes, np.array([1, -1, 1, -1], np.float32)])
    x = np.concatenate([x, np.roll(axes, 1), np.array([1, 1, -1, -1],
                                                      np.float32)])
    got = tops.fast_atan2_deg(torch.from_numpy(y), torch.from_numpy(x))
    want = np.asarray(jops.fast_atan2_deg(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = tops.atan2_deg_exact(torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_allclose(exact.numpy(), np.asarray(jops.atan2_deg_exact(
        jnp.asarray(y), jnp.asarray(x))), atol=1e-4)
    err = np.abs(got.numpy() - exact.numpy())
    err = np.minimum(err, 360.0 - err)
    assert err.max() <= 0.011


def test_image_moments_and_hu():
    rs = np.random.default_rng(7)
    img = rs.integers(0, 256, (48, 1282), dtype=np.uint8)
    img[:, 900:] = 0
    got = tops.image_moments(torch.from_numpy(img), 3)
    want = jops.image_moments(jnp.asarray(img), 3)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], 1e-6)
    blob = np.zeros((64, 80), np.uint8)
    blob[10:40, 20:70] = 200
    blob[25:55, 30:40] = 90
    _close(tops.hu_moments(torch.from_numpy(blob)),
           jops.hu_moments(jnp.asarray(blob)), 1e-4)


def test_integer_pow_forms_cubes_as_the_reference():
    """x^3 at x up to 1281 passes 2^24: x * (x * x) is what XLA computes,
    and what the port computes."""
    xs = torch.arange(1282, dtype=torch.float32)
    want = np.asarray(jnp.arange(1282, dtype=jnp.float32) ** 3)
    np.testing.assert_array_equal(tops._ipow(xs, 3).numpy(), want)
    np.testing.assert_array_equal(tops._ipow(xs, 2).numpy(), np.asarray(
        jnp.arange(1282, dtype=jnp.float32) ** 2))


# ---------------------------------------------------------------- PCA

def _pca_data(seed=8, n=120, d=16):
    rs = np.random.default_rng(seed)
    basis = rs.normal(size=(4, d))
    return (rs.normal(size=(n, 4)) * [5, 3, 2, 1]) @ basis + rs.normal(
        0, 0.1, (n, d)) + 3.0


def test_pca_compute_project_backproject():
    data = _pca_data().astype(np.float32)
    m = tpca.pca_compute(torch.from_numpy(data), 4)
    jm = jpca.pca_compute(jnp.asarray(data), 4)
    _close(m.mean, jm.mean)
    _close(m.values, jm.values)
    _up_to_sign(m.vectors.numpy(), np.asarray(jm.vectors), axis=1)
    # on the reference's own model, projections agree
    mj = model_from_numpy(tpca.PcaModel, jm)
    proj = tpca.pca_project(mj, torch.from_numpy(data))
    _close(proj, jpca.pca_project(jm, jnp.asarray(data)))
    _close(tpca.pca_backproject(mj, proj),
           jpca.pca_backproject(jm, jnp.asarray(proj.numpy())))
    back = model_to_numpy(mj)
    np.testing.assert_array_equal(back["vectors"], np.asarray(jm.vectors))


def test_pca_json_files_load_in_both_packages(tmp_path):
    data = _pca_data(9).astype(np.float32)
    m = tpca.pca_compute(torch.from_numpy(data), 3)
    tpca.pca_save_json(m, str(tmp_path / "port.json"))
    jm = jpca.pca_load_json(str(tmp_path / "port.json"))
    for name in ("mean", "vectors", "values"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(m, name).numpy())
    jpca.pca_save_json(jm, str(tmp_path / "ref.json"))
    back = tpca.pca_load_json(str(tmp_path / "ref.json"), device="cpu")
    for name in ("mean", "vectors", "values"):
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      getattr(m, name).numpy())
