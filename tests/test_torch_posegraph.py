"""Port parity of ``slam/posegraph.py`` against ``compv_tpu`` on the same
numpy inputs (CPU), with the reference's ring bars
(``tests/test_slam_io.py:15-93``).

Tolerances, each with its reason:
* compose / invert / relative_pose: 1e-5 absolute (the same f32 formulas;
  sin, cos and arccos of two math libraries);
* graph residuals and costs at fixed poses: 1e-5 relative;
* the linearization at a zero increment: the forward-mode derivative of
  ``rodrigues_to_matrix`` at exactly 0 against ``jax.jvp``'s, 1e-6;
* the optimized graph: the reference's own bars (translation error below
  0.7x the initial one, cost below 1.5x the ground truth's and below 0.05x
  the initial cost) for both packages; the final cost within 1e-3
  relative of the reference's and the poses within 1e-3 (20-25 damped GN
  steps of 30 f32 CG iterations, whose sums run in another order: the
  iterates carry that rounding, and the cost is the stable quantity);
* two runs of the port on one device: identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.slam import posegraph as jpg
from compv_tpu_torch.interop import (config_from_reference,
                                     pose_graph_from_numpy,
                                     pose_graph_to_numpy)
from compv_tpu_torch.math.rotation import rodrigues_to_matrix
from compv_tpu_torch.slam import posegraph as tpg


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


def make_ring(n=8, noise=0.02, seed=2):
    """tests/test_slam_io.py:38-81: a ring of poses, noisy odometry, an
    exact loop closure of weight 100, initialized by chaining the
    odometry; built here with the port's SE(3) helpers."""
    rs = np.random.default_rng(seed)
    true = np.zeros((n, 6), np.float32)
    for i in range(n):
        ang = 2 * np.pi * i / n
        true[i, :3] = [0, 0, ang]
        true[i, 3:] = [np.cos(ang), np.sin(ang), 0.0]
    tt = torch.from_numpy(true)
    ei, ej, meas, w = [], [], [], []
    for i in range(n):
        j = (i + 1) % n
        rv, tv = tpg.relative_pose(tt[i, :3], tt[i, 3:], tt[j, :3], tt[j, 3:])
        m = np.concatenate([rv.numpy(), tv.numpy()])
        if j != 0:
            m = m + rs.normal(0, noise, 6)
        ei.append(i)
        ej.append(j)
        meas.append(m)
        w.append(1.0 if j != 0 else 100.0)
    init = np.zeros_like(true)
    init[0] = true[0]
    for i in range(1, n):
        m = torch.as_tensor(meas[i - 1], dtype=torch.float32)
        rv, tv = tpg.compose(torch.from_numpy(init[i - 1, :3]),
                             torch.from_numpy(init[i - 1, 3:]), m[:3], m[3:])
        init[i, :3] = rv.numpy()
        init[i, 3:] = tv.numpy()
    graph = {"poses": init, "edge_i": np.array(ei, np.int32),
             "edge_j": np.array(ej, np.int32),
             "edge_meas": np.stack(meas).astype(np.float32),
             "edge_weight": np.array(w, np.float32),
             "edge_valid": np.ones(len(ei), bool)}
    return graph, true


def _jgraph(g):
    return jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})


def test_se3_helpers_equal_reference():
    rs = np.random.default_rng(0)
    a = rs.normal(0, 0.5, (5, 6)).astype(np.float32)
    b = rs.normal(0, 0.5, (5, 6)).astype(np.float32)
    for i in range(5):
        for jf, tf, args in (
                (jpg.compose, tpg.compose, (a[i, :3], a[i, 3:], b[i, :3],
                                            b[i, 3:])),
                (jpg.invert, tpg.invert, (a[i, :3], a[i, 3:])),
                (jpg.relative_pose, tpg.relative_pose,
                 (a[i, :3], a[i, 3:], b[i, :3], b[i, 3:]))):
            want = jf(*[jnp.asarray(x) for x in args])
            got = tf(*[torch.from_numpy(x) for x in args])
            for g_, w_ in zip(got, want):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                           atol=1e-5)
    # batched, and the reference test's identities
    rv, tv = tpg.invert(torch.from_numpy(a[:, :3]), torch.from_numpy(a[:, 3:]))
    rc, tc = tpg.compose(torch.from_numpy(a[:, :3]), torch.from_numpy(a[:, 3:]),
                         rv, tv)
    np.testing.assert_allclose(rc.numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0, atol=1e-5)
    rr, tr = tpg.relative_pose(torch.from_numpy(a[:, :3]),
                               torch.from_numpy(a[:, 3:]),
                               torch.from_numpy(b[:, :3]),
                               torch.from_numpy(b[:, 3:]))
    rb, tb = tpg.compose(torch.from_numpy(a[:, :3]), torch.from_numpy(a[:, 3:]),
                         rr, tr)
    np.testing.assert_allclose(rb.numpy(), b[:, :3], atol=1e-4)
    np.testing.assert_allclose(tb.numpy(), b[:, 3:], atol=1e-4)


def test_rodrigues_jvp_at_zero_equals_reference():
    """The pose graph differentiates Exp at exactly 0 (the zero
    increment): the port's select-safe branches give the reference's
    jvp."""
    from compv_tpu.slam.ba import rodrigues_to_matrix as jrod
    rs = np.random.default_rng(1)
    for _ in range(4):
        v = rs.normal(0, 1, 3).astype(np.float32)
        _, want = jax.jvp(jrod, (jnp.zeros(3, jnp.float32),),
                          (jnp.asarray(v),))
        _, got = torch.func.jvp(rodrigues_to_matrix, (torch.zeros(3),),
                                (torch.from_numpy(v),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("n", [8, 64])
def test_graph_residuals_equal_reference(n):
    g, true = make_ring(n)
    g["edge_valid"][n // 2] = False
    want = np.asarray(jpg.graph_residuals(jnp.asarray(g["poses"]),
                                          _jgraph(g)))
    got = tpg.graph_residuals(torch.from_numpy(g["poses"]),
                              pose_graph_from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[n // 2].any()


@pytest.mark.parametrize("n,iterations", [(8, 25), (64, 20)])
def test_optimize_ring(n, iterations):
    """tests/test_slam_io.py:83-93's bars, for both packages on one graph,
    and the port's cost against the reference's."""
    g, true = make_ring(n)
    jcfg = jpg.PoseGraphConfig(iterations=iterations)
    jg2, jcost = jpg.optimize_pose_graph(_jgraph(g), jcfg)
    tg = pose_graph_from_numpy(g)
    tg2, tcost = tpg.optimize_pose_graph(tg, config_from_reference(jcfg))
    cost_true = float((tpg.graph_residuals(torch.from_numpy(true), tg)
                       ** 2).sum())
    cost_init = float((tpg.graph_residuals(tg.poses, tg) ** 2).sum())
    terr0 = np.abs(g["poses"][:, 3:] - true[:, 3:]).mean()
    for poses, cost in ((np.asarray(jg2.poses), float(jcost)),
                        (tg2.poses.numpy(), float(tcost))):
        assert np.abs(poses[:, 3:] - true[:, 3:]).mean() < 0.7 * terr0
        assert cost < cost_true * 1.5 + 1e-3
        assert cost < 0.05 * cost_init
    assert float(tcost) == pytest.approx(float(jcost), rel=1e-3)
    np.testing.assert_allclose(tg2.poses.numpy(), np.asarray(jg2.poses),
                               atol=1e-3)
    assert torch.equal(tg2.edge_meas, tg.edge_meas)
    # pose 0 is the gauge
    assert torch.equal(tg2.poses[0], tg.poses[0])


def test_optimize_deterministic_and_round_trip():
    g, _ = make_ring(16, seed=5)
    tg = pose_graph_from_numpy(g)
    cfg = tpg.PoseGraphConfig(iterations=6, cg_iterations=10)
    a, ca = tpg.optimize_pose_graph(tg, cfg)
    b, cb = tpg.optimize_pose_graph(tg, cfg)
    assert torch.equal(a.poses, b.poses) and torch.equal(ca, cb)
    back = pose_graph_to_numpy(a)
    assert set(back) == set(tpg.PoseGraph._fields)
    assert back["edge_i"].dtype == np.int32
    np.testing.assert_array_equal(back["poses"], a.poses.numpy())


def test_slam_package_exports():
    import compv_tpu.slam as jslam
    import compv_tpu_torch.slam as tslam
    for name in ("PoseGraph", "PoseGraphConfig", "optimize_pose_graph",
                 "compose", "invert", "relative_pose", "PlanarTrackerConfig",
                 "PlanarTrackResult", "track_planar_sequence",
                 "KeyframeStore", "decompose_homography"):
        assert hasattr(jslam, name) and hasattr(tslam, name), name
