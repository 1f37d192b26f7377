"""Port parity of the SfM slice (``slam/sfm.py``: render_orbit_sequence,
run_sfm, resume_sfm, sfm_ate) against ``compv_tpu`` on the CPU, the JAX
package's checkpoint resumed in the port, and the 8-frame golden met by the
port (slow tier).

What is held, and how closely:
* the rendered frames, ground truth and K: exact (0 differing pixels);
* tracks, the bootstrap pair (the essential RANSAC's inputs) and the
  essential inliers: exact (ORB, matching and the threefry samples are the
  same integers; the RANSAC scores no error within rounding of its
  threshold here);
* the trajectory: ATE within max(1.5x the reference's, 3% of the span),
  the reference's bar for a resumed run (tests/test_sfm.py). Past the
  bootstrap, each local BA is a float32 CG solve of a system whose
  monocular scale direction is nearly free; rounding of another summation
  order moves its iterates, so poses, PnP inlier counts and the map
  diverge within that bar rather than to a fixed tolerance;
* the windowed Schur run: which cameras' observations each BA solve takes
  and which cameras it freezes, exact; each checkpoint's bookkeeping
  exact; its mid-run trajectory and the final one within the same bar
  (the reduced camera system S is ill-conditioned there, and float32
  Schur steps of the two packages from one state already differ).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.io import serialize as jser
from compv_tpu.slam import ba_schur as jbs
from compv_tpu.slam import evaluate as jev
from compv_tpu.slam import sfm as js
from compv_tpu_torch.interop import config_from_reference, sfm_state_from_numpy
from compv_tpu_torch.slam import ba as tba
from compv_tpu_torch.slam import ba_schur as tbs
from compv_tpu_torch.slam import evaluate as tev
from compv_tpu_torch.slam import sfm as ts

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ate(mod, positions, gt):
    if mod is tev:
        return float(tev.ate_rmse(torch.tensor(positions, dtype=torch.float32),
                                  torch.tensor(gt, dtype=torch.float32)))
    return float(jev.ate_rmse(jnp.asarray(positions), jnp.asarray(gt)))


def _centers(cams: np.ndarray) -> np.ndarray:
    """Camera centers -R^T t of (N, 6) [rvec | tvec] poses."""
    rms = tba.rodrigues_to_matrix(torch.tensor(cams[:, :3])).numpy()
    return -np.einsum("nji,nj->ni", rms, cams[:, 3:])


def _recording(monkeypatch, module):
    """Record the inputs and result of run_sfm's find_essential call."""
    calls = []
    inner = module.find_essential

    def rec(src, dst, k, mask, config):
        res = inner(src, dst, k, mask, config)
        as_np = (lambda t: t.detach().cpu().numpy()) if module is ts \
            else np.asarray
        calls.append({"src": as_np(src), "dst": as_np(dst),
                      "mask": as_np(mask), "inliers": as_np(res.inliers)})
        return res

    monkeypatch.setattr(module, "find_essential", rec)
    return calls


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames, gt, k = js.render_orbit_sequence(6, 120, 160)
    frames_t, gt_t, k_t = ts.render_orbit_sequence(6, 120, 160,
                                                   device="cpu")
    cfg = js.SfmConfig(max_obs=4096, max_landmarks=1024)
    ck_ref = str(tmp_path_factory.mktemp("ck_ref"))
    ck_port = str(tmp_path_factory.mktemp("ck_port"))
    with pytest.MonkeyPatch.context() as mp:
        ess_ref = _recording(mp, js)
        ess_port = _recording(mp, ts)
        ref = js.run_sfm(frames, k, cfg, checkpoint_dir=ck_ref)
        port = ts.run_sfm(frames, k, config_from_reference(cfg),
                          checkpoint_dir=ck_port, device="cpu")
    return {"frames": frames, "gt": gt, "k": k, "render_port":
            (frames_t, gt_t, k_t), "cfg": cfg, "ref": ref, "port": port,
            "ess_ref": ess_ref, "ess_port": ess_port, "ck_ref": ck_ref,
            "ck_port": ck_port}


def test_render_orbit_sequence_equals_reference(runs):
    frames_t, gt_t, k_t = runs["render_port"]
    assert frames_t.dtype == np.uint8 and frames_t.shape == (6, 120, 160)
    assert int((frames_t != runs["frames"]).sum()) == 0
    np.testing.assert_array_equal(gt_t, runs["gt"])
    np.testing.assert_array_equal(k_t, runs["k"])


def test_tracks_bootstrap_and_essential_inliers_exact(runs):
    ref, port = runs["ref"], runs["port"]
    assert port.num_tracks == ref.num_tracks > 300
    (er,), (ep,) = runs["ess_ref"], runs["ess_port"]
    for name in ("src", "dst", "mask", "inliers"):
        np.testing.assert_array_equal(ep[name], er[name], err_msg=name)
    # the bootstrap frame's stats: (map points, essential inliers)
    nm, ni = int(er["mask"].sum()), int(er["inliers"].sum())
    assert {"map_pts": nm, "pnp_inliers": ni} in port.frame_stats
    assert [s["map_pts"] for s in port.frame_stats].index(nm) == \
        [s["map_pts"] for s in ref.frame_stats].index(nm)


def test_trajectory_within_the_resume_bar(runs):
    gt = runs["gt"]
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    ate_ref = _ate(jev, runs["ref"].positions, gt)
    ate_port = _ate(tev, runs["port"].positions, gt)
    assert ate_port <= max(1.5 * ate_ref, 0.03 * span), (ate_port, ate_ref)
    assert ate_port < 0.15 * span
    port = runs["port"]
    assert port.reproj_after < port.reproj_before and port.reproj_after < 2.5
    assert port.positions.shape == (6, 3) and port.cameras.shape == (6, 6)
    assert np.isfinite(port.positions).all()


def test_resume_from_the_reference_checkpoint(runs):
    """The JAX package's mid-run state (its checkpoint, loaded by its own
    load_checkpoint) finished by the port, against the JAX resume."""
    cfg, gt = runs["cfg"], runs["gt"]
    path = os.path.join(runs["ck_ref"], sorted(os.listdir(runs["ck_ref"]))[-1])
    like = {"cams": np.zeros((0, 6), np.float32),
            "landmarks": np.zeros((0, 3), np.float32),
            "lm_valid": np.zeros((0,), bool),
            "ob_ci": np.zeros((0,), np.int32),
            "ob_li": np.zeros((0,), np.int32),
            "ob_uv": np.zeros((0, 2), np.float32),
            "ob_ok": np.zeros((0,), bool), "k": np.zeros((3, 3), np.float32),
            "n_tracks": np.zeros((1,), np.int32),
            "n_obs": np.zeros((1,), np.int32)}
    state = sfm_state_from_numpy(jser.load_checkpoint(path, like))
    assert state["ob_ok"].dtype == torch.bool
    port = ts.resume_sfm(state, config_from_reference(cfg), device="cpu")
    ref = js.resume_sfm(path, cfg, mesh=None)
    assert port.num_obs == ref.num_obs and port.num_tracks == ref.num_tracks
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    ate_ref, ate_port = _ate(jev, ref.positions, gt), _ate(tev, port.positions,
                                                           gt)
    assert ate_port <= max(1.5 * ate_ref, 0.03 * span), (ate_port, ate_ref)
    assert port.reproj_after == pytest.approx(ref.reproj_after, rel=0.2)


def test_resume_from_own_checkpoint(runs):
    cfg, gt = config_from_reference(runs["cfg"]), runs["gt"]
    names = sorted(os.listdir(runs["ck_port"]))
    assert names == ["step_6.pt"]
    res = ts.resume_sfm(os.path.join(runs["ck_port"], names[0]), cfg,
                        device="cpu")
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    direct = _ate(tev, runs["port"].positions, gt)
    assert _ate(tev, res.positions, gt) <= max(1.5 * direct, 0.03 * span)
    assert res.num_obs == runs["port"].num_obs


def _windowed_run(monkeypatch, module, frames, k, cfg, ckpt_dir):
    """run_sfm with cfg, recording each BA solve's (cameras with a valid
    observation, cam_mask) and each checkpoint's state."""
    solves, ckpts = [], []
    if module is ts:
        inner_solve, inner_save = ts._solve, ts.save_checkpoint

        def solve(prob, c, solver, cam_mask=None):
            ci = prob.cam_idx[prob.valid].numpy()
            solves.append((sorted(set(ci.tolist())), None if cam_mask is None
                           else cam_mask.numpy().copy(), prob))
            return inner_solve(prob, c, solver, cam_mask)

        def save(directory, step, tree):
            ckpts.append({n: np.array(v) for n, v in tree.items()})
            return inner_save(directory, step, tree)

        monkeypatch.setattr(ts, "_solve", solve)
        monkeypatch.setattr(ts, "save_checkpoint", save)
        res = ts.run_sfm(frames, k, config_from_reference(cfg),
                         checkpoint_dir=ckpt_dir, device="cpu")
    else:
        inner_solve, inner_save = jbs.ba_solve_schur, jser.save_checkpoint

        def solve(prob, c, cam_mask=None):
            ci = np.asarray(prob.cam_idx)[np.asarray(prob.valid)]
            solves.append((sorted(set(ci.tolist())), None if cam_mask is None
                           else np.asarray(cam_mask).copy(), prob))
            return inner_solve(prob, c, cam_mask=cam_mask)

        def save(directory, step, tree):
            ckpts.append({n: np.array(v) for n, v in tree.items()})
            return inner_save(directory, step, tree)

        monkeypatch.setattr(jbs, "ba_solve_schur", solve)
        monkeypatch.setattr(jser, "save_checkpoint", save)
        res = js.run_sfm(frames, k, cfg, checkpoint_dir=ckpt_dir)
    return res, solves, ckpts


@pytest.fixture(scope="module")
def windowed(runs, tmp_path_factory):
    """Both packages' run_sfm with the Schur solver and a 1-frame window
    (older cameras frozen, the observations of one more window of frozen
    frames kept as anchors, so from frame 3 on the oldest frames leave the
    solve), checkpoints every 2 frames, on the same frames."""
    frames, k = runs["frames"], runs["k"]
    cfg = js.SfmConfig(solver="schur", local_window=1, checkpoint_every=2,
                       max_obs=4096, max_landmarks=1024)
    with pytest.MonkeyPatch.context() as mp:
        ess_ref = _recording(mp, js)
        ess_port = _recording(mp, ts)
        ref = _windowed_run(mp, js, frames, k, cfg,
                            str(tmp_path_factory.mktemp("w_ref")))
        port = _windowed_run(mp, ts, frames, k, cfg,
                             str(tmp_path_factory.mktemp("w_port")))
    return ref, port, ess_ref, ess_port


def test_windowed_schur_run(runs, windowed):
    """The windowed Schur run against the reference: every BA solve takes
    the same cameras' observations and freezes the same cameras (a changed
    window rule fails here); tracks and the essential inliers exact; each
    checkpoint holds the same bookkeeping; the trajectory within the
    resume bar, max(1.5x the reference's ATE, 3% of the span)."""
    gt = runs["gt"]
    (ref, solves_ref, ck_ref), (port, solves_port, ck_port), ess_ref, \
        ess_port = windowed

    assert port.num_tracks == ref.num_tracks
    for name in ("src", "dst", "mask", "inliers"):
        np.testing.assert_array_equal(ess_port[0][name], ess_ref[0][name])
    # the local solves, then the final BA's two
    assert len(solves_port) == len(solves_ref) == len(runs["frames"]) + 1
    for (cams_p, mask_p, _), (cams_r, mask_r, _) in zip(solves_port,
                                                        solves_ref):
        assert cams_p == cams_r
        assert (mask_p is None) == (mask_r is None)
        if mask_p is not None:
            np.testing.assert_array_equal(mask_p, mask_r)
    assert any(m is not None and not m.all() for _, m, _ in solves_ref)
    assert any(c[0] > 0 for c, m, _ in solves_ref if m is not None)
    # each checkpoint: the same bookkeeping and registered frames, and a
    # mid-run trajectory within the resume bar of the reference's
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    assert len(ck_port) == len(ck_ref) >= 2
    for cp, cr in zip(ck_port, ck_ref):
        for name in ("n_tracks", "k"):
            np.testing.assert_array_equal(cp[name], cr[name], err_msg=name)
        frames_p = np.unique(cp["ob_ci"][cp["ob_ok"]])
        np.testing.assert_array_equal(frames_p,
                                      np.unique(cr["ob_ci"][cr["ob_ok"]]))
        ate_p, ate_r = (_ate(tev, _centers(c["cams"][frames_p]), gt[frames_p])
                        for c in (cp, cr))
        assert ate_p <= max(1.5 * ate_r, 0.03 * span), (ate_p, ate_r)

    ate_ref = _ate(jev, ref.positions, gt)
    ate_port = _ate(tev, port.positions, gt)
    assert ate_port <= max(1.5 * ate_ref, 0.03 * span), (ate_port, ate_ref)
    assert port.reproj_after < port.reproj_before and port.reproj_after < 2.5


def test_windowed_schur_steps_track_float64(windowed):
    """Each windowed local BA of the run, solved from its float32 problem,
    against the same solve of the problem in float64: cameras within 1e-4.
    The Schur step's linear algebra runs in float64 (slam/ba_schur.py);
    assembled in float32, S is ill-conditioned enough on these problems
    that the accepted steps, and the cameras, part by up to tenths."""
    solves = [(p, m) for _, m, p in windowed[1][1] if m is not None]
    assert len(solves) >= 4
    cfg = tbs.SchurConfig(iterations=5, robust_delta=3.0)
    for prob, mask in solves:
        p64 = prob._replace(cameras=prob.cameras.double(),
                            landmarks=prob.landmarks.double(),
                            intrinsics=prob.intrinsics.double(),
                            uv=prob.uv.double())
        got = tbs.ba_solve_schur(prob, cfg, torch.from_numpy(mask))[0]
        want = tbs.ba_solve_schur(p64, cfg, torch.from_numpy(mask))[0]
        assert float((got.cameras.double() - want.cameras).abs().max()) \
            < 1e-4


def test_entry_points_default_to_the_card(runs):
    """Without device=, the numpy-in entry points ask for the card, and
    raise where there is none: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the refusal without one")
    frames, gt, k = runs["frames"], runs["gt"], runs["k"]
    for call in (lambda: ts.render_orbit_sequence(2, 32, 48),
                 lambda: ts.run_sfm(frames, k),
                 lambda: ts.sfm_ate(frames, gt, k),
                 lambda: ts.resume_sfm({})):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()


@pytest.mark.slow
def test_golden_8_frames_on_cpu():
    """goldens/sfm.json's bars (tests/test_sfm.py::TestSfmEndToEnd), met by
    the port: ATE and RPE within 2x the golden, ATE < 3% of the span, BA
    lowers the reprojection error to under 2.5 px, every frame registered
    with 20 or more PnP inliers."""
    with open(os.path.join(_ROOT, "goldens", "sfm.json")) as f:
        g = json.load(f)
    seq = g["sequence"]
    frames, gt, k = ts.render_orbit_sequence(seq["n_frames"], seq["h"],
                                             seq["w"], device="cpu")
    ate, res = ts.sfm_ate(frames, gt, k, device="cpu")
    rpe = float(tev.rpe_rmse(torch.tensor(res.positions, dtype=torch.float32),
                             torch.tensor(gt, dtype=torch.float32)))
    span = float(np.linalg.norm(gt[-1] - gt[0]))
    assert ate <= 2.0 * g["ate_rmse"], (ate, g["ate_rmse"])
    assert rpe <= 2.0 * g["rpe_rmse"], (rpe, g["rpe_rmse"])
    assert ate < 0.03 * span
    assert res.reproj_after < res.reproj_before and res.reproj_after < 2.5
    assert res.num_obs > 1500 and res.num_tracks > 400
    assert all(st["pnp_inliers"] >= 20 for st in res.frame_stats)
