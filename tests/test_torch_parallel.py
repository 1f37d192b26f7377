"""Port parity of ``parallel/`` (``mesh``, ``distributed``, ``_collectives``,
``sharded``, ``launch``) and the distributed forms of ``slam/ba.py``,
``slam/ba_schur.py`` and ``slam/sfm.py``, on the CPU: spawned ``gloo``
groups of 2 ranks (and one of 4), each with a time limit, against the
reference's distributed functions on its 2-device mesh (``make_mesh(2)``
of the 8-device virtual CPU mesh that tests/conftest.py sets) and against
the port's single-process functions.

One group runs every check of a module fixture (spawning a group takes
~5 s); the ranks' results come back as CPU tensors. The rank functions are
at the top level of this module, which imports neither JAX nor
``compv_tpu`` at import (the ranks import it); the reference runs in the
test process.

What is held, and how closely:
* ``sharded_detect``, ``sharded_orb_detect``, ``sharded_all_pairs_match``
  and ``ring_all_pairs_match``: bit-equal to the port's local loop on every
  rank; the single-level detect and its all-pairs matrix (both forms)
  bit-equal to the reference's all-gather form (integer distances, one
  f32 division); the 8-level ORB against the reference with
  tests/test_torch_orb.py's kind of bars (its levels >= 1 differ from the
  reference's by its own rounding);
* distributed BA steps: two runs bit-identical, and every rank the same
  bits (ordered sums); against the port's single-process step and the
  reference's distributed step at the reference's tolerances
  (tests/test_ba.py): psum step cost rtol 1e-4, cameras rtol 2e-3 / atol
  2e-4; reduce-scatter against psum cost rtol 1e-5, cameras rtol 5e-3 /
  atol 5e-4; Schur cost rtol 1e-4, cameras rtol 2e-2 / atol 1e-3, RMSE
  within 5 %. Not bit-equal to the single-process step: each rank's
  segment sums add its own observations, and the ranks' partials are then
  added, an order the single table does not have;
* ``resume_sfm(mesh=D 2)`` of a single-process checkpoint: ATE within
  max(1.5x the direct run's, 3 % of the span) (tests/test_sfm.py).

The D=4 group checks determinism in the fast tier; its other checks (the
frontend and BA at D=4 against the local result, the resume at D=4) are
``slow``: they repeat the D=2 checks at another size and add a 4-process
spawn.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from compv_tpu_torch.features.orb import OrbConfig
from compv_tpu_torch.interop import ba_problem_from_numpy
from compv_tpu_torch.parallel import _collectives, distributed as tdist
from compv_tpu_torch.parallel import launch, mesh as tmesh, sharded
from compv_tpu_torch.slam import ba as tba
from compv_tpu_torch.slam import ba_schur as tbs

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240.0
ORB_FULL = dict(max_features=128)
BA_CFG = dict(cg_iterations=10)


def _frames():
    """tests/test_parallel.py's frames: 16 of 64x96, seed 0."""
    from scipy import ndimage
    rs = np.random.default_rng(0)
    out = []
    for _ in range(16):
        img = ndimage.gaussian_filter(
            rs.uniform(0, 255, (64, 96)).astype(np.float32), 1.2)
        out.append(((img - img.min()) / (np.ptp(img) + 1e-9) * 255
                    ).astype(np.uint8))
    return np.stack(out)


def _rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _ba_scene(seed, pad=8, by_landmark=False, pad_to=None, unseen=()):
    """tests/test_ba.py's make_scene(n_cams=4, n_lms=16) with its noise:
    cameras 1-3 perturbed by 0.01, landmarks by 0.02; ``pad`` invalid
    observations appended (``pad_to``: up to that count). ``by_landmark``
    orders the observations by landmark, so that each rank of 2 holds all
    of a landmark's (the ``lm_partitioned`` case); the observations of the
    ``unseen`` landmarks are marked invalid."""
    rs = np.random.default_rng(seed)
    n_cams, n_lms = 4, 16
    lms = rs.uniform(-1, 1, (n_lms, 3)) + np.array([0, 0, 5.0])
    cams = np.stack([np.concatenate([
        rs.normal(0, 0.05, 3),
        np.array([0.4 * i - 0.6, 0.0, 0.0]) + rs.normal(0, 0.05, 3)])
        for i in range(n_cams)])
    intr = np.array([500.0, 500.0, 320.0, 240.0])
    ci, li, uv = [], [], []
    for c in range(n_cams):
        r = _rodrigues(cams[c, :3])
        for lm in range(n_lms):
            pc = r @ lms[lm] + cams[c, 3:]
            ci.append(c)
            li.append(lm)
            uv.append([intr[0] * pc[0] / pc[2] + intr[2],
                       intr[1] * pc[1] / pc[2] + intr[3]])
    ci, li = np.array(ci, np.int32), np.array(li, np.int32)
    uv = np.array(uv)
    cams_n = (cams + rs.normal(0, 0.01, cams.shape)).astype(np.float32)
    cams_n[0] = cams[0]
    lms_n = (lms + rs.normal(0, 0.02, lms.shape)).astype(np.float32)
    if by_landmark:
        order = np.argsort(li, kind="stable")
        ci, li, uv = ci[order], li[order], uv[order]
    n = len(ci)
    if pad_to is not None:
        pad = pad_to - n
    return {"cameras": cams_n, "landmarks": lms_n,
            "intrinsics": intr.astype(np.float32),
            "cam_idx": np.concatenate([ci, np.zeros(pad, np.int32)]),
            "lm_idx": np.concatenate([li, np.zeros(pad, np.int32)]),
            "uv": np.concatenate([uv, np.zeros((pad, 2))]).astype(np.float32),
            "valid": np.concatenate([~np.isin(li, unseen),
                                     np.zeros(pad, bool)])}


SCENES = {"psum": (5, {}), "rs": (6, {}), "schur": (9, {}),
          "schur_lm": (9, {"by_landmark": True, "pad": 0}),
          # landmarks 4-7 unseen: a chunk of 4 that no rank observes
          "schur_gaps": (9, {"unseen": (4, 5, 6, 7)}),
          # every observation of rank 1 of 2 is padding
          "idle_rank": (5, {"pad_to": 128})}


def _steps(mesh, scenes):
    """Each distributed step on its scene, run twice."""
    lam = torch.tensor(1e-3)
    cfg = tba.BAConfig(**BA_CFG)
    made = {
        "psum": sharded.make_distributed_ba_step(mesh, cfg),
        "rs": sharded.make_distributed_ba_step(mesh, cfg, "reduce_scatter"),
        "rs_psum": sharded.make_distributed_ba_step(mesh, cfg),
        "schur": sharded.make_distributed_schur_step(mesh),
        "schur_lm": sharded.make_distributed_schur_step(
            mesh, tbs.SchurConfig(lm_partitioned=True)),
        "schur_gaps": sharded.make_distributed_schur_step(
            mesh, tbs.SchurConfig(lm_chunk=4)),
        "idle_rank": sharded.make_distributed_ba_step(mesh, cfg),
    }
    out = {}
    for name, step in made.items():
        prob = ba_problem_from_numpy(scenes["rs" if name == "rs_psum"
                                            else name])
        runs = [step(prob, lam) for _ in range(2)]
        out[name] = [(p.cameras, p.landmarks, lam_new, cost)
                     for p, lam_new, cost in runs]
    return out


def _frontend(mesh, frames):
    imgs = torch.from_numpy(frames)
    x, y, s, v, d = sharded.sharded_detect(imgs, mesh, max_features=64)
    orb = sharded.sharded_orb_detect(imgs, mesh, OrbConfig(**ORB_FULL))
    return {"detect": (x, y, s, v, d), "orb": orb,
            "all_pairs": sharded.sharded_all_pairs_match(d, v, mesh),
            "ring": sharded.ring_all_pairs_match(d, v, mesh)}


def rank_group2(mesh, frames, scenes, checkpoint, sfm_cfg, port):
    """Every D=2 check of one rank."""
    torch.set_num_threads(1)
    out = {"frontend": _frontend(mesh, frames), "steps": _steps(mesh, scenes)}
    # the multi-host smoke's bring-up: explicit address, world size and rank
    tdist.init_distributed(f"127.0.0.1:{port}", 2, mesh.rank)  # re-entry
    try:
        tdist.init_distributed(f"127.0.0.1:{port}", 3, mesh.rank)
        out["other_size"] = "accepted"
    except RuntimeError:
        out["other_size"] = "raised"
    out["world"] = (dist.get_world_size(), dist.get_backend(),
                    tdist.global_frame_mesh(device="cpu").size,
                    tdist.process_frame_slice(7))
    # a 1 x 2 mesh: its "tile" sub-group holds both ranks
    m2 = tmesh.make_mesh_2d(1, 2, device="cpu")
    t = torch.tensor([float(mesh.rank)])
    out["mesh_2d"] = (m2["frame"].size, m2["tile"].size,
                      _collectives.all_gather_cat(t, m2["tile"]),
                      _collectives.ring_shift(t, m2["tile"]),
                      _collectives.broadcast(t + 5, m2["tile"], src=1))
    from compv_tpu_torch.slam import sfm as ts
    out["resume"] = ts.resume_sfm(checkpoint, sfm_cfg, mesh=mesh).positions
    out["resume_schur"] = ts.resume_sfm(
        checkpoint, dataclasses.replace(sfm_cfg, solver="schur"),
        mesh=mesh).positions
    out["schur_solve"] = _schur_solve(mesh, scenes)
    return out


def _schur_solve(mesh, scenes):
    prob = ba_problem_from_numpy(scenes["schur"])
    return sharded.distributed_ba_solve(
        prob, mesh, tbs.SchurConfig(iterations=3))[0].cameras


def rank_group4(mesh, frames, scenes, slow):
    torch.set_num_threads(1)
    out = {"steps": _steps(mesh, scenes)}
    if slow:
        out["frontend"] = _frontend(mesh, frames)
    return out


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's own torch work on one thread, restored after: on a
    loaded host (the other test workers) a many-threaded CPU run_sfm
    stalls on its thread pool's barriers, minutes for seconds of work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def scenes():
    return {name: _ba_scene(seed, **kw) for name, (seed, kw) in SCENES.items()}


@pytest.fixture(scope="module")
def sfm_run(tmp_path_factory):
    """The port's single-process 6-frame run with a checkpoint
    (tests/test_sfm.py's resume case)."""
    from compv_tpu_torch.slam import sfm as ts
    frames, gt, k = ts.render_orbit_sequence(6, 120, 160, device="cpu")
    cfg = ts.SfmConfig(max_obs=4096, max_landmarks=1024)
    ck = str(tmp_path_factory.mktemp("ck"))
    res = ts.run_sfm(frames, k, cfg, checkpoint_dir=ck, device="cpu")
    path = os.path.join(ck, sorted(os.listdir(ck))[-1])
    return {"gt": gt, "cfg": cfg, "direct": res.positions, "path": path}


@pytest.fixture(scope="module")
def group2(frames, scenes, sfm_run):
    return launch.spawn(rank_group2, 2,
                        (frames, scenes, sfm_run["path"], sfm_run["cfg"],
                         launch.free_port()),
                        device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def local(frames, scenes):
    """The port's single-process results (a mesh of size 1)."""
    m1 = tmesh.make_mesh(1, device="cpu")
    return {"frontend": _frontend(m1, frames), "steps": _steps(m1, scenes),
            "schur_solve": tbs.ba_solve_schur(
                ba_problem_from_numpy(scenes["schur"]),
                tbs.SchurConfig(iterations=3))[0].cameras}


@pytest.fixture(scope="module")
def ref(frames, scenes):
    """The reference's distributed functions on its 2-device mesh."""
    import jax
    import jax.numpy as jnp
    from compv_tpu.features.orb import OrbConfig as JOrbConfig
    from compv_tpu.parallel import mesh as jmesh, sharded as jsh
    from compv_tpu.slam import ba as jba, ba_schur as jbs

    m = jmesh.make_mesh(2)
    imgs = jnp.asarray(frames)
    det = jsh.sharded_detect(imgs, m, max_features=64)
    out = {"detect": [np.asarray(a) for a in det],
           "orb": jax.tree_util.tree_map(
               np.asarray, jsh.sharded_orb_detect(imgs, m,
                                                  JOrbConfig(**ORB_FULL))),
           "all_pairs": np.asarray(jsh.sharded_all_pairs_match(det[4], det[3],
                                                               m))}
    cfg = jba.BAConfig(**BA_CFG)
    steps = {"psum": jsh.make_distributed_ba_step(m, cfg),
             "rs": jsh.make_distributed_ba_step(m, cfg, "reduce_scatter"),
             "schur": jsh.make_distributed_schur_step(m),
             # the reference's lm_partitioned branch does not trace under
             # shard_map (its scan carry turns device-varying), so this
             # case is held to its single-device step
             "schur_lm": jax.jit(lambda p, lam: jbs.ba_step_schur(
                 p, lam, jbs.SchurConfig(lm_partitioned=True)))}
    for name, step in steps.items():
        prob = jba.BAProblem(**{k: jnp.asarray(v)
                                for k, v in scenes[name].items()})
        p, _, cost = step(prob, jnp.float32(1e-3))
        out[name] = (np.asarray(p.cameras), float(cost))
    return out


# ---------------------------------------------------------------- helpers

def _same(a, b):
    """Bit-equal trees of tensors."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _rmse(scene, cams):
    prob = ba_problem_from_numpy({**scene, "cameras": np.asarray(cams)})
    return float(tba.reproj_rmse(prob))


# ---------------------------------------------------------------- frontend

def test_sharded_detect_equals_local_and_reference(group2, local, ref):
    for rank in group2:
        assert _same(rank["frontend"]["detect"], local["frontend"]["detect"])
    for got, want in zip(local["frontend"]["detect"], ref["detect"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_orb_detect_equals_local(group2, local, ref):
    """The 8-level pipeline at D=2 bit-equal to the port's loop; against
    the reference's sharded_orb_detect, tests/test_torch_orb.py's bars."""
    got = group2[0]["frontend"]["orb"]
    assert _same(got, local["frontend"]["orb"])
    assert _same(got, group2[1]["frontend"]["orb"])
    kp, want = got.keypoints, ref["orb"].keypoints
    for name in ("x", "y", "strength", "level", "size", "valid"):
        np.testing.assert_array_equal(getattr(kp, name).numpy(),
                                      getattr(want, name))
    d = np.abs(kp.orientation.numpy() - want.orientation)
    d = np.minimum(d, 360.0 - d)[want.valid]
    level = want.level[want.valid]
    assert d[level == 0].max() <= 1e-4
    assert d[level > 0].max() <= 0.5
    bits = got.descriptors.numpy()
    assert (bits != ref["orb"].descriptors).mean() <= 1e-3


def test_all_pairs_and_ring_bit_equal(group2, local, ref):
    want = local["frontend"]["all_pairs"]
    assert want.shape == (16, 16)
    assert torch.equal(torch.diagonal(want), torch.zeros(16))
    for rank in group2:
        assert torch.equal(rank["frontend"]["all_pairs"], want)
        assert torch.equal(rank["frontend"]["ring"], want)
    assert torch.equal(local["frontend"]["ring"], want)
    # the reference's own ring equals its all-gather form
    # (tests/test_parallel.py), which the port's forms equal bit for bit
    np.testing.assert_array_equal(want.numpy(), ref["all_pairs"])


def test_pair_sim_equals_reference():
    import jax.numpy as jnp
    from compv_tpu.parallel import sharded as jsh
    rs = np.random.default_rng(3)
    d1 = rs.integers(0, 2, (32, 256), dtype=np.uint8)
    d2 = rs.integers(0, 2, (5, 32, 256), dtype=np.uint8)
    v1 = rs.random(32) < 0.8
    v2 = rs.random((5, 32)) < 0.7
    v2[3] = False                      # a frame without a valid point
    got = sharded._pair_sim(torch.from_numpy(d1), torch.from_numpy(v1),
                            torch.from_numpy(d2), torch.from_numpy(v2))
    want = [float(jsh._pair_sim(jnp.asarray(d1), jnp.asarray(v1),
                                jnp.asarray(d2[i]), jnp.asarray(v2[i])))
            for i in range(5)]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))


# ---------------------------------------------------------------- BA

def _check_step(name, group, local, ref=None):
    """Two runs bit-identical on every rank, ranks equal, held to the
    single-process step (and the reference's distributed one)."""
    runs = group[0]["steps"][name]
    assert _same(runs[0], runs[1])
    for rank in group[1:]:
        assert _same(rank["steps"][name], runs)
    cams, _, _, cost = runs[0]
    lcams, _, _, lcost = local["steps"][name][0]
    tol = (2e-2, 1e-3) if name.startswith("schur") else (2e-3, 2e-4)
    assert float(cost) == pytest.approx(float(lcost), rel=1e-4)
    np.testing.assert_allclose(cams.numpy(), lcams.numpy(), rtol=tol[0],
                               atol=tol[1])
    if ref is not None:
        rcams, rcost = ref[name]
        assert float(cost) == pytest.approx(rcost, rel=1e-4)
        np.testing.assert_allclose(cams.numpy(), rcams, rtol=tol[0],
                                   atol=tol[1])
    return cams


def test_distributed_psum_step(group2, local, ref):
    _check_step("psum", group2, local, ref)


def test_distributed_step_with_an_idle_rank(group2, local, scenes):
    """Rank 1 holds only padding, and still takes part in every sum."""
    assert not scenes["idle_rank"]["valid"][64:].any()
    cams = _check_step("idle_rank", group2, local)
    assert _rmse(scenes["idle_rank"], cams) < _rmse(
        scenes["idle_rank"], scenes["idle_rank"]["cameras"])


def test_reduce_scatter_step(group2, local, ref, scenes):
    cams = _check_step("rs", group2, local)
    ps_cams, _, _, ps_cost = group2[0]["steps"]["rs_psum"][0]
    _, _, _, cost = group2[0]["steps"]["rs"][0]
    assert float(cost) == pytest.approx(float(ps_cost), rel=1e-5)
    np.testing.assert_allclose(cams.numpy(), ps_cams.numpy(), rtol=5e-3,
                               atol=5e-4)
    rcams, rcost = ref["rs"]
    assert float(cost) == pytest.approx(rcost, rel=1e-5)
    np.testing.assert_allclose(cams.numpy(), rcams, rtol=5e-3, atol=5e-4)
    assert _rmse(scenes["rs"], cams) < _rmse(scenes["rs"],
                                             scenes["rs"]["cameras"])


def test_distributed_schur_step_skips_unseen_chunks(group2, local):
    _check_step("schur_gaps", group2, local)


@pytest.mark.parametrize("name", ["schur", "schur_lm"])
def test_distributed_schur_step(group2, local, ref, scenes, name):
    """Held to the port's single-process step at the reference's
    tolerances. Against the reference: the cost, and the RMSE the update
    lands at within 5 %. The reference's Schur algebra is float32 (the
    port's float64), and its own distributed step differs from its
    single-device one by up to 0.015 in a camera parameter on this scene
    (one free scale direction), past its 2e-2 / 1e-3 bars; its cameras
    are not a finer reference than that."""
    cams = _check_step(name, group2, local)
    lcams = local["steps"][name][0][0]
    assert _rmse(scenes[name], cams) == pytest.approx(
        _rmse(scenes[name], lcams), rel=0.05, abs=1e-3)
    rcams, rcost = ref[name]
    assert float(group2[0]["steps"][name][0][3]) == pytest.approx(rcost,
                                                                  rel=1e-4)
    assert _rmse(scenes[name], cams) == pytest.approx(
        _rmse(scenes[name], rcams), rel=0.05, abs=1e-3)


@pytest.mark.parametrize("d", [2, 4])
def test_lm_partitioned_scene_is_partitioned(scenes, d):
    """Each landmark's observations lie on one rank of ``d``."""
    li = scenes["schur_lm"]["lm_idx"]
    assert scenes["schur_lm"]["valid"].all() and len(li) % d == 0
    owners = [set(part) for part in np.split(li, d)]
    assert sum(len(o) for o in owners) == len(set(li)) == 16


def test_ba_step_mesh_of_one_is_the_local_step(scenes):
    """``psum_axis`` a mesh of size 1: the same bits as no mesh."""
    prob = ba_problem_from_numpy(scenes["psum"])
    cfg = tba.BAConfig(**BA_CFG, precondition=True)
    m1 = tmesh.make_mesh(1, device="cpu")
    a = tba.ba_step(prob, torch.tensor(1e-3), cfg)
    b = tba.ba_step(prob, torch.tensor(1e-3), cfg, psum_axis=m1)
    assert _same(a[0], b[0]) and _same(a[1:], b[1:])
    # with a chunk of 4 landmarks that nothing observes, which the mesh
    # skips
    prob = ba_problem_from_numpy(scenes["schur_gaps"])
    scfg = tbs.SchurConfig(lm_chunk=4)
    c = tbs.ba_step_schur(prob, torch.tensor(1e-3), scfg)
    d = tbs.ba_step_schur(prob, torch.tensor(1e-3), scfg, psum_axis=m1)
    assert _same(c[0], d[0]) and _same(c[1:], d[1:])


# ---------------------------------------------------------------- resume

def test_resume_on_two_ranks(group2, sfm_run):
    from compv_tpu_torch.slam.evaluate import ate_rmse
    gt = torch.tensor(sfm_run["gt"], dtype=torch.float32)

    def ate(pos):
        return float(ate_rmse(torch.as_tensor(pos, dtype=torch.float32), gt))

    span = float(np.linalg.norm(sfm_run["gt"][-1] - sfm_run["gt"][0]))
    direct = ate(sfm_run["direct"])
    for rank in group2:
        assert ate(rank["resume"]) <= max(1.5 * direct, 0.03 * span)
        assert ate(rank["resume"]) < 0.15 * span
    np.testing.assert_array_equal(group2[0]["resume"], group2[1]["resume"])


def test_resume_on_two_ranks_with_the_schur_solver(group2, sfm_run):
    """``solver="schur"``: the final BA runs distributed Schur steps, held
    to the single-process Schur resume by the same bar."""
    import dataclasses as dc
    from compv_tpu_torch.slam import sfm as ts
    from compv_tpu_torch.slam.evaluate import ate_rmse
    gt = torch.tensor(sfm_run["gt"], dtype=torch.float32)

    def ate(pos):
        return float(ate_rmse(torch.as_tensor(pos, dtype=torch.float32), gt))

    single = ts.resume_sfm(sfm_run["path"],
                           dc.replace(sfm_run["cfg"], solver="schur"),
                           device="cpu").positions
    span = float(np.linalg.norm(sfm_run["gt"][-1] - sfm_run["gt"][0]))
    for rank in group2:
        assert ate(rank["resume_schur"]) <= max(1.5 * ate(single),
                                                0.03 * span)
    np.testing.assert_array_equal(group2[0]["resume_schur"],
                                  group2[1]["resume_schur"])


def test_distributed_schur_solve(group2, local):
    """distributed_ba_solve with a SchurConfig: Schur steps, held to
    ba_solve_schur at the Schur step's tolerances."""
    for rank in group2:
        np.testing.assert_allclose(rank["schur_solve"].numpy(),
                                   local["schur_solve"].numpy(), rtol=2e-2,
                                   atol=1e-3)


# ---------------------------------------------------------------- bring-up

def test_group_bring_up(group2):
    """scripts/multihost_worker.py's analogue: init_distributed from an
    explicit address, world size and rank; re-entry at that size is a
    no-op, another size raises; the global mesh and frame slices."""
    for rank, out in enumerate(group2):
        assert out["other_size"] == "raised"
        assert out["world"] == (2, "gloo", 2, [(0, 4), (4, 7)][rank])
        f, t, gathered, shifted, bcast = out["mesh_2d"]
        assert (f, t) == (1, 2)
        assert gathered.tolist() == [0.0, 1.0]
        assert shifted.tolist() == [float(1 - rank)]
        assert bcast.tolist() == [6.0]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_process_frame_slice(monkeypatch, d):
    import jax
    from compv_tpu.parallel import distributed as jdist
    monkeypatch.setattr(jax, "process_count", lambda: d)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: d)
    for n in (1, 7, 10):
        for r in range(d):
            monkeypatch.setattr(jax, "process_index", lambda: r)
            monkeypatch.setattr(dist, "get_rank", lambda group=None: r)
            assert tdist.process_frame_slice(n) == jdist.process_frame_slice(n)


def test_single_process_helpers(monkeypatch):
    for key in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    tdist.init_distributed()                   # nothing to join
    assert not dist.is_initialized()
    assert tdist.process_frame_slice(10) == (0, 10)
    m = tdist.global_frame_mesh(device="cpu")
    assert (m.size, m.rank, m.group, m.device) == (1, 0, None,
                                                   torch.device("cpu"))
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cpu")
    m2 = tmesh.make_mesh_2d(1, 1, device="cpu")
    assert m2["frame"].size == m2["tile"].size == 1
    t = torch.arange(6.0).reshape(3, 2)
    for fn in (_collectives.all_gather_cat, _collectives.ordered_sum,
               _collectives.reduce_scatter_ordered, _collectives.ring_shift,
               _collectives.broadcast):
        assert torch.equal(fn(t, m), t)
    sh = tmesh.frame_sharding(m)
    assert torch.equal(sh.unshard([sh.shard(t)]), t)
    assert tmesh.replicated(m).shard(t) is t
    assert tmesh.P("frame") == ("frame",) and tmesh.P() == ()


def test_row_sharding_needs_an_even_split():
    m = tmesh.FrameMesh(None, 1, 2, torch.device("cpu"))
    sh = tmesh.frame_sharding(m)
    assert sh.shard(torch.arange(6)).tolist() == [3, 4, 5]
    with pytest.raises(ValueError):
        sh.shard(torch.arange(5))


def test_choose_backend(monkeypatch):
    assert tdist.choose_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert tdist.choose_backend(2) == "nccl"          # one rank per card
    assert tdist.choose_backend(4) == "gloo"          # ranks share cards
    assert tdist.choose_backend(4, local_size=2) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tdist.choose_backend(1) == "gloo"


def test_import_starts_no_process_group():
    """Importing the package, with a launcher's environment set, joins no
    group."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT="1",
               RANK="0", WORLD_SIZE="2")
    code = ("import torch.distributed as d, compv_tpu_torch; "
            "assert compv_tpu_torch.parallel.sharded_orb_detect; "
            "assert not d.is_initialized(); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def rank_fails(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        launch.spawn(rank_fails, 2, device="cpu", timeout=SPAWN_TIMEOUT)


# ---------------------------------------------------------------- D = 4

def test_four_ranks_bit_identical_runs(frames, scenes):
    """At D=4: two runs of each step bit-identical, on every rank."""
    group = launch.spawn(rank_group4, 4, (frames, scenes, False),
                         device="cpu", timeout=SPAWN_TIMEOUT)
    for name in ("psum", "rs", "schur", "schur_lm", "schur_gaps",
                 "idle_rank"):
        runs = group[0]["steps"][name]
        assert _same(runs[0], runs[1])
        for rank in group[1:]:
            assert _same(rank["steps"][name], runs)


@pytest.mark.slow
def test_four_ranks_against_local(frames, scenes, local):
    group = launch.spawn(rank_group4, 4, (frames, scenes, True),
                         device="cpu", timeout=SPAWN_TIMEOUT)
    for rank in group:
        assert _same(rank["frontend"]["detect"], local["frontend"]["detect"])
        assert _same(rank["frontend"]["orb"], local["frontend"]["orb"])
        assert torch.equal(rank["frontend"]["ring"],
                           local["frontend"]["all_pairs"])
        assert torch.equal(rank["frontend"]["all_pairs"],
                           local["frontend"]["all_pairs"])
    for name in ("psum", "rs", "schur", "schur_lm", "schur_gaps"):
        _check_step(name, group, local)


@pytest.mark.slow
def test_resume_on_four_ranks(sfm_run):
    from compv_tpu_torch.slam.evaluate import ate_rmse
    group = launch.spawn(rank_resume, 4, (sfm_run["path"], sfm_run["cfg"]),
                         device="cpu", timeout=SPAWN_TIMEOUT)
    gt = torch.tensor(sfm_run["gt"], dtype=torch.float32)
    span = float(np.linalg.norm(sfm_run["gt"][-1] - sfm_run["gt"][0]))
    direct = float(ate_rmse(torch.tensor(sfm_run["direct"],
                                         dtype=torch.float32), gt))
    for rank in group:
        got = float(ate_rmse(torch.as_tensor(rank, dtype=torch.float32), gt))
        assert got <= max(1.5 * direct, 0.03 * span)


def rank_resume(mesh, path, cfg):
    torch.set_num_threads(1)
    from compv_tpu_torch.slam import sfm as ts
    return ts.resume_sfm(path, cfg, mesh=mesh).positions
