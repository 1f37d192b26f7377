"""Port parity of ``slam/ba.py``, ``slam/ba_schur.py``, ``slam/evaluate.py``
and ``math/rotation.py`` against ``compv_tpu`` on the same numpy inputs
(CPU), the locked BA goldens, and the copy of ``quantized_hash``.

Tolerances, each with its reason:
* rotations both ways: 1e-6 absolute (the same f32 formulas; sin, cos,
  arccos of two math libraries);
* ``index_table``, gauge masks, ``quantized_hash``: exact;
* residuals and Jacobian blocks: 1e-6 relative to the largest entry
  (forward-mode derivatives of the same f32 expressions, summed in another
  order by the 3x3 products);
* one ``ba_step``: cost_before to 1e-6 relative, the BA golden's cost and
  camera hash exactly; after a CG step of a noisy scene, cameras to 1e-3
  and landmarks (depth ~5) to 2e-3 where a second camera is pinned (20 CG iterations stop
  far from convergence, and the iterates carry float32 rounding of
  another summation order), the cost to 1e-3 relative where none is (the
  monocular scale is then a near-null direction of the damped normal
  system, along which that rounding moves the step); an exact Schur step
  to 1e-4;
* solves of noise-free scenes (CG with and without block-Jacobi, IRLS,
  windowed): final cost within 1e-3 relative or 0.01 (both at the float32
  floor, rmse ~0.005 px), cameras within 1e-3; Schur
  solves: of a noisy scene with two cameras pinned, cost to 1e-3 and
  parameters to 1e-4; of a noise-free scene with one (the scale direction
  again), the costs at the float32 floor within 0.01;
* ATE / RPE / Umeyama: 1e-5 relative (3x3 SVD of another LAPACK).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.core import golden as jgolden
from compv_tpu.slam import ba as jba
from compv_tpu.slam import ba_schur as jbs
from compv_tpu.slam import evaluate as jev
from compv_tpu_torch.core import golden as tgolden
from compv_tpu_torch.interop import (ba_problem_from_numpy,
                                     ba_problem_to_numpy,
                                     config_from_reference)
from compv_tpu_torch.slam import ba as tba
from compv_tpu_torch.slam import ba_schur as tbs
from compv_tpu_torch.slam import evaluate as tev


def _np(t):
    return t.detach().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------- rotations

ROTATIONS = {
    "zero": [0.0, 0.0, 0.0],
    "tiny": [1e-7, -2e-7, 0.0],
    "small": [1e-5, 3e-5, -2e-5],
    "general": [0.3, -0.8, 0.5],
    "near_pi_x": [np.pi - 1e-4, 0.0, 0.0],
    "near_pi_oblique": [1.8, -2.2, 1.0],
    "pi_diag": [np.pi / np.sqrt(3)] * 3,
}


@pytest.mark.parametrize("name", sorted(ROTATIONS))
def test_rodrigues_both_ways(name):
    rv = np.asarray(ROTATIONS[name], np.float32)
    want_r = np.asarray(jba.rodrigues_to_matrix(jnp.asarray(rv)))
    got_r = _np(tba.rodrigues_to_matrix(torch.from_numpy(rv)))
    np.testing.assert_allclose(got_r, want_r, atol=1e-6)
    want_v = np.asarray(jba.matrix_to_rodrigues(jnp.asarray(want_r)))
    got_v = _np(tba.matrix_to_rodrigues(torch.from_numpy(want_r)))
    np.testing.assert_allclose(got_v, want_v, atol=1e-6)


def test_rodrigues_round_trip_batched():
    rs = np.random.default_rng(0)
    rv = rs.normal(0, 1, (64, 3)).astype(np.float32)
    rv = rv / np.maximum(np.linalg.norm(rv, axis=1, keepdims=True), 1) * 3.0
    r = tba.rodrigues_to_matrix(torch.from_numpy(rv))
    want = np.stack([np.asarray(jba.rodrigues_to_matrix(jnp.asarray(v)))
                     for v in rv])
    np.testing.assert_allclose(_np(r), want, atol=1e-6)
    # both packages on the same matrices: near pi the angle's arccos
    # amplifies a matrix's rounding sevenfold, so each reads the reference's
    back = _np(tba.matrix_to_rodrigues(torch.from_numpy(want)))
    want_back = np.asarray(jax.vmap(jba.matrix_to_rodrigues)(jnp.asarray(want)))
    np.testing.assert_allclose(back, want_back, atol=1e-6)
    np.testing.assert_allclose(_np(tba.matrix_to_rodrigues(r)), rv,
                               atol=1e-4)


def test_rodrigues_gradient_is_finite_at_zero():
    v = torch.zeros(3, requires_grad=True)
    tba.rodrigues_to_matrix(v).sum().backward()
    assert torch.isfinite(v.grad).all()


# ---------------------------------------------------------------- problems

def _golden_problem():
    """scripts/make_goldens.py:_ba_golden_problem, as numpy."""
    rs = np.random.default_rng(23)
    f, l, o = 16, 200, 1600
    cams = np.concatenate([rs.normal(0, 0.05, (f, 3)),
                           rs.normal(0, 0.5, (f, 3)) + [0, 0, 4]], 1)
    lms = rs.normal(0, 1.5, (l, 3)) + [0, 0, 8]
    return {"cameras": cams.astype(np.float32),
            "landmarks": lms.astype(np.float32),
            "intrinsics": np.array([400.0, 400.0, 240.0, 180.0], np.float32),
            "cam_idx": rs.integers(0, f, o).astype(np.int32),
            "lm_idx": rs.integers(0, l, o).astype(np.int32),
            "uv": (rs.normal(0, 40.0, (o, 2)) + 200).astype(np.float32),
            "valid": np.ones((o,), bool)}


def _scene(seed, n_cams=5, n_lms=30, noise_px=0.5, outliers=True, pad=24,
           exact_cams=1):
    """tests/test_ba.py's scene (cameras around a landmark cloud), with
    pixel noise, a few gross outliers and padded invalid observations; the
    first ``exact_cams`` cameras start at the truth, the others perturbed."""
    rs = np.random.default_rng(seed)
    lms = rs.uniform(-1, 1, (n_lms, 3)) + [0, 0, 5.0]
    cams = np.stack([np.concatenate([rs.normal(0, 0.05, 3),
                                     [0.4 * i - 0.6, 0, 0]
                                     + rs.normal(0, 0.05, 3)])
                     for i in range(n_cams)])
    intr = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    ci = np.repeat(np.arange(n_cams), n_lms).astype(np.int32)
    li = np.tile(np.arange(n_lms), n_cams).astype(np.int32)
    uv = np.asarray(jax.jit(jba.project_points)(
        jnp.asarray(cams, jnp.float32), jnp.asarray(lms, jnp.float32),
        jnp.asarray(intr), jnp.asarray(ci), jnp.asarray(li)))
    uv = uv + rs.normal(0, noise_px, uv.shape)
    if outliers:
        uv[::13] += 25.0
    cams_n = cams + rs.normal(0, 0.01, cams.shape)
    cams_n[:exact_cams] = cams[:exact_cams]
    lms_n = lms + rs.normal(0, 0.02, lms.shape)
    o = len(ci)
    return {"cameras": cams_n.astype(np.float32),
            "landmarks": lms_n.astype(np.float32), "intrinsics": intr,
            "cam_idx": np.concatenate([ci, np.zeros(pad, np.int32)]),
            "lm_idx": np.concatenate([li, np.zeros(pad, np.int32)]),
            "uv": np.concatenate([uv, np.full((pad, 2), 1e5)]
                                 ).astype(np.float32),
            "valid": np.concatenate([np.ones(o, bool), np.zeros(pad, bool)])}


def _both(arrs):
    return (jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            ba_problem_from_numpy(arrs))


# ---------------------------------------------------------------- goldens

def test_quantized_hash_copy_equals_original():
    rs = np.random.default_rng(5)
    for a in (rs.normal(0, 3, (16, 6)).astype(np.float32),
              np.array([-0.0, 0.0, 1.0005, -2.4995]), np.zeros((0, 3))):
        for d in (1, 3, 5):
            assert tgolden.quantized_hash(a, d) == jgolden.quantized_hash(a, d)
            assert tgolden.quantized_hash(torch.from_numpy(
                np.ascontiguousarray(a)), d) == jgolden.quantized_hash(a, d)


def test_ba_step_goldens():
    """goldens/goldens.json's BA values, met by the port: ba_step with
    CG = 8 from lambda 1e-3 on the 16-cam / 200-lm / 1600-obs problem."""
    import json
    import os
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "goldens", "goldens.json")) as f:
        g = json.load(f)
    prob = ba_problem_from_numpy(_golden_problem())
    p1, lam1, cost = tba.ba_step(prob, torch.tensor(1e-3),
                                 tba.BAConfig(cg_iterations=8))
    assert round(float(cost), 1) == g["ba_step_cost_before"]
    assert tgolden.quantized_hash(p1.cameras, 3) == g["ba_step_cam_hash_q3"]
    assert float(lam1) == pytest.approx(5e-4)


# ---------------------------------------------------------------- blocks

def test_project_points_and_residuals():
    arrs = _scene(1)
    jp, tp = _both(arrs)
    want = np.asarray(jax.jit(jba.project_points)(jp.cameras, jp.landmarks,
                                         jp.intrinsics, jp.cam_idx,
                                         jp.lm_idx))
    got = _np(tba.project_points(tp.cameras, tp.landmarks, tp.intrinsics,
                                 tp.cam_idx, tp.lm_idx))
    assert _rel(got, want) <= 1e-6
    assert float(tba.reproj_rmse(tp)) == pytest.approx(
        float(jba.reproj_rmse(jp)), rel=1e-6)
    r = _np(tba.ba_residuals(tp.cameras, tp.landmarks, tp))
    assert not r[~arrs["valid"]].any()


@pytest.mark.parametrize("which", ["golden", "scene"])
def test_obs_jacobian_blocks(which):
    arrs = _golden_problem() if which == "golden" else _scene(2)
    jp, tp = _both(arrs)
    want = jax.jit(jba.obs_jacobian_blocks)(jp.cameras, jp.landmarks, jp.intrinsics,
                                   jp.cam_idx, jp.lm_idx, jp.uv, jp.valid)
    got = tba.obs_jacobian_blocks(tp.cameras, tp.landmarks, tp.intrinsics,
                                  tp.cam_idx, tp.lm_idx, tp.uv, tp.valid)
    for g, w in zip(got, want):
        assert _rel(_np(g), np.asarray(w)) <= 1e-6


def test_index_table_equals_reference_table():
    arrs = _scene(3)
    o = len(arrs["lm_idx"])
    for k in (4, 8):
        want, want_c = jbs._obs_of_lm_table(jnp.asarray(arrs["lm_idx"]),
                                            jnp.asarray(arrs["valid"]), 30,
                                            k, o)
        got, got_c = tbs._obs_of_lm_table(torch.from_numpy(arrs["lm_idx"]),
                                          torch.from_numpy(arrs["valid"]),
                                          30, k, o)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(_np(got_c), np.asarray(want_c))
    table, counts = tba.index_table(torch.from_numpy(arrs["cam_idx"]),
                                    torch.from_numpy(arrs["valid"]), 5)
    assert table.shape == (5, 30) and counts.tolist() == [30] * 5
    vals = torch.arange(o, dtype=torch.float32)[:, None]
    want_sum = np.zeros(5)
    np.add.at(want_sum, arrs["cam_idx"][arrs["valid"]],
              np.arange(o)[arrs["valid"]])
    np.testing.assert_array_equal(_np(tba.segment_sum(table, vals))[:, 0],
                                  want_sum)


def test_inv3x3_spd():
    rs = np.random.default_rng(4)
    a = rs.normal(0, 1, (32, 3, 3)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    assert _rel(_np(tba.inv3x3_spd(torch.from_numpy(m))),
                np.asarray(jba.inv3x3_spd(jnp.asarray(m)))) <= 1e-6


def _ray_block():
    """A damped landmark block seen along one ray, s v v^T + lam I in
    float32 (SPD: its float64 eigenvalues are positive), whose float32
    adjugate det comes out <= 0: the first of seed 0's draws that does."""
    rs = np.random.default_rng(0)
    while True:
        v = rs.normal(size=3)
        v /= np.linalg.norm(v)
        m = (10 ** rs.uniform(3, 6) * np.outer(v, v)
             + 10 ** rs.uniform(-4, -1) * np.eye(3)).astype(np.float32)
        m = (m + m.T) / 2
        inv32 = tba.inv3x3_spd(torch.from_numpy(m)).numpy()
        if np.linalg.eigvalsh(m.astype(np.float64)).min() > 0 and not (
                np.isfinite(inv32).all()
                and np.linalg.eigvalsh(inv32.astype(np.float64)).min() > 0):
            return m, inv32


def test_preconditioner_blocks_inverted_in_float64(monkeypatch):
    """The float32 adjugate of such a block is not SPD (or not finite); the
    float64 one, cast back, is the inverse. ba_step(precondition=True)
    inverts its landmark blocks in float64."""
    m, inv32 = _ray_block()
    m64 = m.astype(np.float64)
    assert np.linalg.det(m64) > 0
    inv = tba.inv3x3_spd(torch.from_numpy(m).double()).float().numpy()
    assert np.isfinite(inv).all()
    assert np.linalg.eigvalsh(inv.astype(np.float64)).min() > 0
    assert _rel(inv, np.linalg.inv(m64)) <= 1e-5
    seen = []
    inner = tba.inv3x3_spd
    monkeypatch.setattr(tba, "inv3x3_spd",
                        lambda x: seen.append(x.dtype) or inner(x))
    prob = ba_problem_from_numpy(_scene(8, noise_px=0.0, outliers=False))
    tba.ba_step(prob, torch.tensor(1e-3),
                tba.BAConfig(cg_iterations=5, precondition=True))
    assert seen == [torch.float64]


# ---------------------------------------------------------------- steps

def test_ba_step_scene():
    """One step, both packages, with IRLS and with a second pinned camera
    (well conditioned: parameters to 1e-4) and without it (cost to 1e-3)."""
    arrs = _scene(6)
    jp, tp = _both(arrs)
    cm = np.array([True, False, True, True, True])
    cfg = jba.BAConfig(cg_iterations=20, robust_delta=3.0)
    tcfg = config_from_reference(cfg)
    step = jba.ba_step     # eager: jit fuses other f32 roundings
    a, la, ca = step(jp, jnp.float32(1e-3), cfg, cam_mask=jnp.asarray(cm))
    b, lb, cb = tba.ba_step(tp, torch.tensor(1e-3), tcfg,
                            cam_mask=torch.from_numpy(cm))
    assert float(cb) == pytest.approx(float(ca), rel=1e-6)
    assert float(lb) == float(la)
    np.testing.assert_allclose(_np(b.cameras), np.asarray(a.cameras),
                               atol=1e-3)
    np.testing.assert_allclose(_np(b.landmarks), np.asarray(a.landmarks),
                               atol=2e-3)
    np.testing.assert_array_equal(_np(b.cameras)[1], arrs["cameras"][1])
    a, _, _ = step(jp, jnp.float32(1e-3), cfg)
    b, _, _ = tba.ba_step(tp, torch.tensor(1e-3), tcfg)
    cost = lambda p, r: float((r * r).sum())       # noqa: E731
    assert cost(b, _np(tba.ba_residuals(b.cameras, b.landmarks, tp))) == \
        pytest.approx(cost(a, np.asarray(jba.ba_residuals(
            a.cameras, a.landmarks, jp))), rel=1e-3)


SOLVES = {
    "cg": dict(iterations=8, cg_iterations=25),
    "pcg": dict(iterations=8, cg_iterations=15, precondition=True),
    "irls": dict(iterations=8, cg_iterations=25, robust_delta=3.0),
    "irls_pcg": dict(iterations=8, cg_iterations=15, robust_delta=3.0,
                     precondition=True),
}


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_ba_solve(name, windowed):
    """Noise-free observations of a padded scene: both packages converge
    to the same answer (windowed: cameras 0 and 1 frozen)."""
    arrs = _scene(8, noise_px=0.0, outliers=False, exact_cams=2)
    jp, tp = _both(arrs)
    cfg = jba.BAConfig(**SOLVES[name])
    cm = np.array([False, False, True, True, True]) if windowed else None
    a, ca = jba.ba_solve(jp, cfg, None if cm is None else jnp.asarray(cm))
    b, cb = tba.ba_solve(tp, config_from_reference(cfg),
                         None if cm is None else torch.from_numpy(cm))
    assert float(jba.reproj_rmse(a)) < 0.05
    assert float(tba.reproj_rmse(b)) < 0.05
    # both end at the float32 floor (rmse ~0.005 px): costs within 0.01
    assert abs(float(cb) - float(ca)) <= max(1e-3 * float(ca), 0.01)
    np.testing.assert_allclose(_np(b.cameras), np.asarray(a.cameras),
                               atol=1e-3)
    if cm is not None:
        np.testing.assert_array_equal(_np(b.cameras)[:2],
                                      arrs["cameras"][:2])


@pytest.mark.parametrize("robust", [0.0, 3.0])
@pytest.mark.parametrize("windowed", [False, True])
def test_ba_solve_schur(robust, windowed):
    # windowed: a noisy scene with two cameras pinned at the truth; else a
    # noise-free one, where both packages reach the float32 floor
    arrs = _scene(7, exact_cams=2) if windowed else _scene(
        7, noise_px=0.0, outliers=False)
    jp, tp = _both(arrs)
    cfg = jbs.SchurConfig(iterations=6, robust_delta=robust, lm_chunk=8)
    cm = np.array([True, False, True, True, True]) if windowed else None
    a, ca = jbs.ba_solve_schur(jp, cfg, None if cm is None
                               else jnp.asarray(cm))
    b, cb = tbs.ba_solve_schur(tp, config_from_reference(cfg),
                               None if cm is None else torch.from_numpy(cm))
    assert abs(float(cb) - float(ca)) <= max(1e-3 * float(ca), 0.01)
    if windowed:   # a second pinned camera fixes the scale: parameters too
        np.testing.assert_allclose(_np(b.cameras), np.asarray(a.cameras),
                                   atol=1e-4)
        np.testing.assert_allclose(_np(b.landmarks),
                                   np.asarray(a.landmarks), atol=1e-4)


def test_schur_step_and_cap():
    arrs = _scene(9, noise_px=0.0, outliers=False)
    jp, tp = _both(arrs)
    k = jbs.max_obs_per_landmark(arrs["lm_idx"], arrs["valid"], 30)
    assert tbs.max_obs_per_landmark(torch.from_numpy(arrs["lm_idx"]),
                                    torch.from_numpy(arrs["valid"]), 30) == k
    cm = np.array([True, True, True, False, True])
    a, la, ca = jax.jit(jbs.ba_step_schur, static_argnames=(
        "cfg", "max_obs_per_lm"))(jp, jnp.float32(1e-3), jbs.SchurConfig(),
                                   max_obs_per_lm=k, cam_mask=jnp.asarray(cm))
    b, lb, cb = tbs.ba_step_schur(tp, torch.tensor(1e-3), tbs.SchurConfig(),
                                  max_obs_per_lm=k,
                                  cam_mask=torch.from_numpy(cm))
    assert float(cb) == pytest.approx(float(ca), rel=1e-6)
    np.testing.assert_allclose(_np(b.cameras), np.asarray(a.cameras),
                               atol=1e-4)


def test_ba_problem_round_trip():
    arrs = _scene(10)
    back = ba_problem_to_numpy(ba_problem_from_numpy(arrs))
    for k, v in arrs.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype


# ---------------------------------------------------------------- evaluate

@pytest.mark.parametrize("with_scale", [True, False])
def test_trajectory_errors(with_scale):
    rs = np.random.default_rng(11)
    gt = np.cumsum(rs.normal(0, 0.1, (24, 3)), axis=0).astype(np.float32)
    r = np.asarray(jba.rodrigues_to_matrix(jnp.asarray([0.2, -0.4, 0.1],
                                                       jnp.float32)))
    est = (0.37 * gt @ r.T + [1.0, -2.0, 0.5]
           + rs.normal(0, 0.01, gt.shape)).astype(np.float32)
    je, jg = jnp.asarray(est), jnp.asarray(gt)
    te, tg = torch.from_numpy(est), torch.from_numpy(gt)
    for want, got in zip(jev.umeyama_alignment(je, jg, with_scale),
                         tev.umeyama_alignment(te, tg, with_scale)):
        assert _rel(_np(got), np.asarray(want)) <= 1e-5
    assert float(tev.ate_rmse(te, tg, with_scale)) == pytest.approx(
        float(jev.ate_rmse(je, jg, with_scale)), rel=1e-5)
    for delta in (1, 3):
        assert float(tev.rpe_rmse(te, tg, delta, with_scale=with_scale)) == \
            pytest.approx(float(jev.rpe_rmse(je, jg, delta,
                                             with_scale=with_scale)),
                          rel=1e-5)
