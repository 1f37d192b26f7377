"""Port parity of ``ml/svm.py`` and ``ml/knn.py`` against ``compv_tpu`` on
the same numpy inputs (CPU): binary SVMs (RBF and linear), cross-validation
folds, one-vs-rest multiclass, eps-SVR, Platt scaling against scipy's
minimum, the probabilistic SVM, exact KNN (l2 and angular), the ANN index,
and the JSON and libsvm model files both ways.

Tolerances, each with its reason:
* SVM duals (alpha_y, beta) and biases: 1e-4 relative to the largest |value|
  (300 projected-gradient steps; the reference runs them jitted, where XLA
  may fuse a step's multiply-add and sums the kernel rows in its order);
* decisions and regressions: 1e-4 relative to the largest |decision|;
  labels equal wherever |decision| >= 1e-3;
* on the reference's own trained model (carried by
  ``interop.model_from_numpy``): decisions within 1e-5 relative, labels
  equal;
* ``platt_fit``: (A, B) within 1e-4 (relative, and absolute near 0) of the
  minimum scipy's BFGS finds in float64 for the same NLL, and an NLL no
  larger; the reference's own fit (``d = t - (1 - p)``,
  ``compv_tpu/ml/svm.py:241``) is not the minimum, so the port is not held
  to it;
* KNN indices: exact (a stable top-k, lower index first among ties, as
  ``lax.top_k``); distances within 1e-5 relative;
* ANN: the hyperplanes within 4 ulp of ``jax.random.normal`` (the
  ``threefry.normal`` bound), the codes of the test data equal; with the
  reference's planes, shortlists and results exact;
* model files: exact (the same decimal text, float32 values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from compv_tpu.ml import knn as jknn
from compv_tpu.ml import svm as jsvm
from compv_tpu_torch.interop import (config_from_reference, model_from_numpy,
                                     model_to_numpy)
from compv_tpu_torch.ml import knn as tknn
from compv_tpu_torch.ml import svm as tsvm


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


def _blobs(seed=0, n=160, d=6, sep=1.6):
    """Two overlapping Gaussian classes, labels +-1."""
    rs = np.random.default_rng(seed)
    y = np.where(rs.random(n) < 0.45, 1.0, -1.0).astype(np.float32)
    x = rs.normal(0, 1, (n, d)) + sep * y[:, None] * np.linspace(
        1, 0.2, d)[None, :]
    return x.astype(np.float32), y


def _rel(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def _np(t):
    return t.detach().cpu().numpy()


CONFIGS = [jsvm.SvmConfig(), jsvm.SvmConfig(kernel="linear", c=0.5),
           jsvm.SvmConfig(gamma=0.5, c=4.0, iterations=150)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["rbf", "linear", "rbf_c4"])
def test_svm_train_and_decision(cfg):
    x, y = _blobs()
    xt, _ = _blobs(1, 120)
    m = tsvm.svm_train(torch.from_numpy(x), torch.from_numpy(y),
                       config_from_reference(cfg))
    jm = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), cfg)
    _rel(_np(m.alpha_y), jm.alpha_y, 1e-4)
    assert abs(float(m.bias) - float(jm.bias)) <= 1e-4 * max(
        1.0, abs(float(jm.bias)))
    assert m.kernel_linear == jm.kernel_linear
    dec = _np(tsvm.svm_decision(m, torch.from_numpy(xt)))
    jdec = np.asarray(jsvm.svm_decision(jm, jnp.asarray(xt)))
    _rel(dec, jdec, 1e-4)
    sure = np.abs(jdec) >= 1e-3
    pred = _np(tsvm.svm_predict(m, torch.from_numpy(xt)))
    np.testing.assert_array_equal(pred[sure], np.asarray(
        jsvm.svm_predict(jm, jnp.asarray(xt)))[sure])
    # the reference's own model in the port
    mj = model_from_numpy(tsvm.SvmModel, jm)
    _rel(_np(tsvm.svm_decision(mj, torch.from_numpy(xt))), jdec, 1e-5)
    np.testing.assert_array_equal(
        _np(tsvm.svm_predict(mj, torch.from_numpy(xt))),
        np.asarray(jsvm.svm_predict(jm, jnp.asarray(xt))))


def test_cross_validate_same_folds():
    x, y = _blobs(2, 150)
    cfg = jsvm.SvmConfig(iterations=100)
    acc = tsvm.svm_cross_validate(torch.from_numpy(x), torch.from_numpy(y),
                                  config_from_reference(cfg), folds=5, seed=3)
    jacc = jsvm.svm_cross_validate(jnp.asarray(x), jnp.asarray(y), cfg,
                                   folds=5, seed=3)
    assert acc == pytest.approx(jacc, abs=1e-12)


def test_multiclass():
    rs = np.random.default_rng(4)
    centres = np.array([[0, 0], [3, 0], [0, 3]], np.float32)
    lab = rs.integers(0, 3, 150)
    x = (centres[lab] + rs.normal(0, 0.8, (150, 2))).astype(np.float32)
    y = (lab * 2 + 1).astype(np.int32)          # classes 1, 3, 5
    xt = (centres[rs.integers(0, 3, 90)] + rs.normal(0, 1.0, (90, 2))
          ).astype(np.float32)
    cfg = jsvm.SvmConfig(gamma=0.5, iterations=200)
    mc = tsvm.svm_train_multiclass(torch.from_numpy(x), torch.from_numpy(y),
                                   config_from_reference(cfg))
    jmc = jsvm.svm_train_multiclass(jnp.asarray(x), jnp.asarray(y), cfg)
    np.testing.assert_array_equal(_np(mc.classes), np.asarray(jmc.classes))
    scores = np.stack([np.asarray(jsvm.svm_decision(m, jnp.asarray(xt)))
                       for m in jmc.models])
    top2 = np.sort(scores, axis=0)[-2:]
    sure = top2[1] - top2[0] >= 1e-3
    got = _np(tsvm.svm_predict_multiclass(mc, torch.from_numpy(xt)))
    want = np.asarray(jsvm.svm_predict_multiclass(jmc, jnp.asarray(xt)))
    np.testing.assert_array_equal(got[sure], want[sure])
    mcj = model_from_numpy(tsvm.MultiClassSvm, jmc)
    np.testing.assert_array_equal(
        _np(tsvm.svm_predict_multiclass(mcj, torch.from_numpy(xt))), want)


def test_median_of_even_count_is_the_mean_of_the_middle_two():
    v = np.array([5.0, 1.0, 4.0, 2.0, 9.0, 3.0], np.float32)
    assert float(tsvm._median(torch.from_numpy(v))) == float(
        jnp.median(jnp.asarray(v))) == 3.5
    assert float(tsvm._median(torch.from_numpy(v[:5]))) == float(
        jnp.median(jnp.asarray(v[:5])))


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_svr(kernel):
    rs = np.random.default_rng(5)
    x = rs.uniform(-3, 3, (120, 1)).astype(np.float32)
    y = (np.sin(x[:, 0]) * 2 + 0.5 * x[:, 0] + 1.0
         + rs.normal(0, 0.1, 120)).astype(np.float32)
    cfg = jsvm.SvmConfig(kernel=kernel, gamma=0.5, c=5.0, iterations=300)
    m = tsvm.svr_train(torch.from_numpy(x), torch.from_numpy(y),
                       config_from_reference(cfg), epsilon=0.1)
    jm = jsvm.svr_train(jnp.asarray(x), jnp.asarray(y), cfg, epsilon=0.1)
    _rel(_np(m.alpha_y), jm.alpha_y, 1e-4)
    assert abs(float(m.bias) - float(jm.bias)) <= 1e-4 * max(
        1.0, abs(float(jm.bias)))
    xt = np.linspace(-3, 3, 50, dtype=np.float32)[:, None]
    _rel(_np(tsvm.svr_predict(m, torch.from_numpy(xt))),
         jsvm.svr_predict(jm, jnp.asarray(xt)), 1e-4)


def _scipy_platt(dec, y):
    """(A, B) at the minimum of libsvm's regularized sigmoid NLL, by BFGS
    in float64, and the NLL there."""
    dec = dec.astype(np.float64)
    n_pos, n_neg = (y > 0).sum(), (y <= 0).sum()
    t = np.where(y > 0, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))

    def nll(ab):
        z = ab[0] * dec + ab[1]
        return float(np.sum(np.logaddexp(0.0, z) - (1.0 - t) * z))

    def grad(ab):
        z = ab[0] * dec + ab[1]
        d = t - 1.0 / (1.0 + np.exp(z))
        return np.array([np.sum(d * dec), np.sum(d)])

    res = scipy.optimize.minimize(nll, np.zeros(2), jac=grad, method="BFGS",
                                  options={"gtol": 1e-10, "maxiter": 1000})
    return res.x, nll, res.fun


@pytest.mark.parametrize("seed,sep", [(6, 1.6), (7, 0.6), (8, 4.0)])
def test_platt_fit_at_scipys_minimum(seed, sep):
    x, y = _blobs(seed, 200, sep=sep)
    jm = jsvm.svm_train(jnp.asarray(x), jnp.asarray(y), jsvm.SvmConfig())
    dec = np.array(jsvm.svm_decision(jm, jnp.asarray(x)))
    a, b = tsvm.platt_fit(torch.from_numpy(dec), torch.from_numpy(y))
    (sa, sb), nll, best = _scipy_platt(dec, y)
    assert abs(float(a) - sa) <= 1e-4 * max(1.0, abs(sa))
    assert abs(float(b) - sb) <= 1e-4 * max(1.0, abs(sb))
    assert nll(np.array([float(a), float(b)])) <= best + 1e-6 * abs(best)
    # the reference's loop ends elsewhere: its NLL is larger (or not finite)
    ja, jb = jsvm.platt_fit(jnp.asarray(dec), jnp.asarray(y))
    ref_nll = nll(np.array([float(ja), float(jb)]))
    assert not np.isfinite(ref_nll) or ref_nll > best + 1e-3 * abs(best)
    p = _np(tsvm.platt_probability(a, b, torch.from_numpy(np.sort(dec))))
    assert np.all((p >= 0) & (p <= 1)) and np.all(np.diff(p) >= 0)


def test_probabilistic_svm():
    x, y = _blobs(9, 150)
    cfg = jsvm.SvmConfig(iterations=150)
    pm = tsvm.svm_train_probabilistic(torch.from_numpy(x), torch.from_numpy(y),
                                      config_from_reference(cfg), folds=3,
                                      seed=1)
    jpm = jsvm.svm_train_probabilistic(jnp.asarray(x), jnp.asarray(y), cfg,
                                       folds=3, seed=1)
    # the decision part is the reference's
    _rel(_np(pm.model.alpha_y), jpm.model.alpha_y, 1e-4)
    # the sigmoid: scipy's minimum on the port's out-of-fold decisions
    order = np.random.default_rng(1).permutation(150)
    dec = np.zeros(150, np.float32)
    for k in range(3):
        val = order[k * 50:(k + 1) * 50]
        m = tsvm.svm_train(torch.from_numpy(x[np.setdiff1d(order, val)]),
                           torch.from_numpy(y[np.setdiff1d(order, val)]),
                           config_from_reference(cfg))
        dec[val] = _np(tsvm.svm_decision(m, torch.from_numpy(x[val])))
    (sa, sb), _, _ = _scipy_platt(dec, y)
    assert abs(float(pm.a) - sa) <= 1e-4 * max(1.0, abs(sa))
    assert abs(float(pm.b) - sb) <= 1e-4 * max(1.0, abs(sb))
    p = _np(tsvm.svm_predict_proba(pm, torch.from_numpy(x)))
    assert np.all((p > 0) & (p < 1))
    assert ((p > 0.5) == (y > 0)).mean() > 0.8
    back = model_from_numpy(tsvm.ProbSvmModel, model_to_numpy(pm))
    assert torch.equal(back.model.support, pm.model.support)
    assert float(back.a) == float(pm.a)


@pytest.mark.parametrize("kind", ["c_svc_rbf", "c_svc_linear", "svr"])
def test_model_files_both_ways(tmp_path, kind):
    x, y = _blobs(10, 60)
    if kind == "svr":
        cfg = jsvm.SvmConfig(gamma=0.3, iterations=100)
        m = tsvm.svr_train(torch.from_numpy(x), torch.from_numpy(y),
                           config_from_reference(cfg))
        svm_type = "epsilon_svr"
    else:
        cfg = jsvm.SvmConfig(kernel="linear" if "linear" in kind else "rbf",
                             iterations=100)
        m = tsvm.svm_train(torch.from_numpy(x), torch.from_numpy(y),
                           config_from_reference(cfg))
        svm_type = "c_svc"
    port_txt = str(tmp_path / "port.model")
    tsvm.svm_save_libsvm(m, port_txt, svm_type)
    jm = jsvm.svm_load_libsvm(port_txt)
    keep = np.abs(_np(m.alpha_y)) > 1e-8
    np.testing.assert_array_equal(np.asarray(jm.support), _np(m.support)[keep])
    np.testing.assert_array_equal(np.asarray(jm.alpha_y), _np(m.alpha_y)[keep])
    assert float(jm.bias) == float(m.bias)
    assert jm.kernel_linear == m.kernel_linear
    ref_txt = str(tmp_path / "ref.model")
    jsvm.svm_save_libsvm(jm, ref_txt, svm_type)
    with open(port_txt) as f1, open(ref_txt) as f2:
        assert f1.read() == f2.read()
    back = tsvm.svm_load_libsvm(ref_txt, device="cpu")
    np.testing.assert_array_equal(_np(back.alpha_y), np.asarray(jm.alpha_y))
    assert float(back.gamma) == float(jm.gamma)
    # JSON
    tsvm.svm_save_json(m, str(tmp_path / "port.json"))
    jj = jsvm.svm_load_json(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(np.asarray(jj.alpha_y), _np(m.alpha_y))
    jsvm.svm_save_json(jj, str(tmp_path / "ref.json"))
    tj = tsvm.svm_load_json(str(tmp_path / "ref.json"), device="cpu")
    for name in ("support", "alpha_y", "bias", "gamma"):
        np.testing.assert_array_equal(_np(getattr(tj, name)),
                                      _np(getattr(m, name)))
    assert tj.kernel_linear == m.kernel_linear


def test_libsvm_label_order_and_errors(tmp_path):
    path = tmp_path / "neg_first.model"
    path.write_text("svm_type c_svc\nkernel_type rbf\ngamma 0.5\nnr_class 2\n"
                    "total_sv 2\nrho 0.25\nlabel -1 1\nnr_sv 1 1\nSV\n"
                    "0.75 1:1 2:2\n-0.75 1:-1 3:4\n")
    m = tsvm.svm_load_libsvm(str(path), device="cpu")
    jm = jsvm.svm_load_libsvm(str(path))
    for name in ("support", "alpha_y", "bias", "gamma"):
        np.testing.assert_array_equal(_np(getattr(m, name)),
                                      np.asarray(getattr(jm, name)))
    bad = tmp_path / "bad.model"
    bad.write_text("svm_type nu_svc\nnr_class 2\nrho 0\nSV\n")
    with pytest.raises(ValueError):
        tsvm.svm_load_libsvm(str(bad), device="cpu")


# ---------------------------------------------------------------- KNN

def _corpus(seed=11, n=180, d=12):
    rs = np.random.default_rng(seed)
    v = rs.normal(0, 1, (n, d)).astype(np.float32)
    v[50] = v[10]                     # ties: equal vectors
    v[51] = v[10]
    q = rs.normal(0, 1, (40, d)).astype(np.float32)
    q[0] = v[10]
    return v, q


@pytest.mark.parametrize("norm", ["l2", "angular"])
def test_knn_exact(norm):
    v, q = _corpus()
    idx, dist = tknn.knn_search(tknn.knn_build(torch.from_numpy(v), norm),
                                torch.from_numpy(q), 7)
    jidx, jdist = jknn.knn_search(jknn.knn_build(jnp.asarray(v), norm),
                                  jnp.asarray(q), 7)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_allclose(_np(dist), np.asarray(jdist), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(_np(idx)[0, :3], [10, 50, 51])


def test_knn_files_and_interop(tmp_path):
    v, q = _corpus(12)
    index = tknn.knn_build(torch.from_numpy(v), "angular")
    tknn.knn_save_json(index, str(tmp_path / "port.json"))
    jindex = jknn.knn_load_json(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(np.asarray(jindex.vectors),
                                  _np(index.vectors))
    jknn.knn_save_json(jindex, str(tmp_path / "ref.json"))
    back = tknn.knn_load_json(str(tmp_path / "ref.json"), device="cpu")
    assert back.norm == "angular"
    assert torch.equal(back.vectors, index.vectors)
    jbuilt = jknn.knn_build(jnp.asarray(v), "angular")
    carried = model_from_numpy(tknn.KnnIndex, jbuilt)
    np.testing.assert_array_equal(
        _np(tknn.knn_search(carried, torch.from_numpy(q), 3)[0]),
        np.asarray(jknn.knn_search(jbuilt, jnp.asarray(q), 3)[0]))
    assert model_to_numpy(carried)["norm"] == "angular"


def test_ann_planes_codes_and_search():
    v, q = _corpus(13, 400, 16)
    cfg = jknn.AnnConfig(n_projections=12, candidates=64, seed=5)
    tcfg = config_from_reference(cfg)
    index = tknn.ann_build(torch.from_numpy(v), tcfg)
    jindex = jknn.ann_build(jnp.asarray(v), cfg)
    # the planes within 4 ulp of jax.random.normal's
    a = _np(index.planes).view(np.int32).astype(np.int64)
    b = np.asarray(jindex.planes).view(np.int32).astype(np.int64)
    assert np.abs(a - b).max() <= 4
    np.testing.assert_array_equal(_np(index.codes), np.asarray(jindex.codes))
    idx, dist = tknn.ann_search(index, torch.from_numpy(q), 5, tcfg)
    jidx, jdist = jknn.ann_search(jindex, jnp.asarray(q), 5, cfg)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_allclose(_np(dist), np.asarray(jdist), rtol=1e-5)
    # on the reference's own index (its planes), bit for bit
    carried = model_from_numpy(tknn.AnnIndex, jindex)
    assert carried.codes.dtype == torch.int32
    cidx, _ = tknn.ann_search(carried, torch.from_numpy(q), 5, tcfg)
    np.testing.assert_array_equal(_np(cidx), np.asarray(jidx))
    # the shortlist evaluated in chunks gives the same answer
    old = tknn._CHUNK_FLOATS
    try:
        tknn._CHUNK_FLOATS = 64 * 16 * 7
        sidx, sdist = tknn.ann_search(index, torch.from_numpy(q), 5, tcfg)
    finally:
        tknn._CHUNK_FLOATS = old
    assert torch.equal(sidx, idx) and torch.equal(sdist, dist)
    # recall against exact search
    exact = _np(tknn.knn_search(tknn.knn_build(torch.from_numpy(v)),
                                torch.from_numpy(q), 5)[0])
    hits = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(_np(idx),
                                                              exact)])
    assert hits > 0.3


def test_configs_convert():
    assert config_from_reference(jsvm.SvmConfig(gamma=0.2, lr=0.01)) == \
        tsvm.SvmConfig(gamma=0.2, lr=0.01)
    assert config_from_reference(jknn.AnnConfig(candidates=9)) == \
        tknn.AnnConfig(candidates=9)
