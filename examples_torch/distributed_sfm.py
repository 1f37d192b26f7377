"""Distributed SfM demo: sharded per-frame detection, cross-shard descriptor
matching, and a distributed BA solve over the ranks of a process group
(BASELINE config 5), on the port: each rank's ORB runs the hand-written
FAST kernel (K1) on its card.

``--ranks`` takes the place of the reference's device count: one rank a
card by default (``torch.cuda.device_count()``); ranks beyond one are
spawned on this host and joined over nccl where there are two cards or
more and one rank a card, over gloo otherwise (``parallel.launch.spawn``).
``--device cpu --ranks 8`` is the reference's run on its virtual 8-device
CPU mesh. Rank 0's results are printed.

    python examples_torch/distributed_sfm.py [--ranks N] [--device cpu]
"""
import argparse

import numpy as np

from common import add_device_arg, pick_device, textured_scene

import torch
from compv_tpu_torch.parallel.launch import spawn
from compv_tpu_torch.parallel.mesh import make_mesh
from compv_tpu_torch.parallel.sharded import (
    distributed_ba_solve, sharded_all_pairs_match, sharded_detect,
)
from compv_tpu_torch.slam.ba import BAConfig, BAProblem, project_points, reproj_rmse


def solve(mesh, frames, cams_n, lms_n, intr, ci, li, uv):
    """One rank's share of the demo, called on every rank of ``mesh``: the
    similarity matrix and the RMSE before and after the distributed BA, by
    the name of the call that made them (as the reference's are recorded),
    and the solved cameras and last cost; the same on every rank."""
    dev = mesh.device
    x, y, s, valid, desc = sharded_detect(torch.from_numpy(frames), mesh,
                                          max_features=64)
    sim = sharded_all_pairs_match(desc, valid, mesh)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    n_obs = len(ci)
    prob = BAProblem(
        cameras=f32(cams_n), landmarks=f32(lms_n), intrinsics=f32(intr),
        cam_idx=torch.from_numpy(ci).to(dev),
        lm_idx=torch.from_numpy(li).to(dev), uv=f32(uv),
        valid=torch.ones(n_obs, dtype=torch.bool, device=dev))
    before = float(reproj_rmse(prob))
    solved, cost = distributed_ba_solve(prob, mesh, BAConfig(iterations=8,
                                                             cg_iterations=25))
    return {"sharded_all_pairs_match": [sim.cpu()],
            "reproj_rmse": [before, float(reproj_rmse(solved))],
            "cameras": solved.cameras.cpu(), "cost": float(cost)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the process group (default: one a card)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    n_dev = args.ranks if args.ranks is not None else torch.cuda.device_count()
    if n_dev < 1:
        raise ValueError(f"--ranks must be at least 1: {n_dev}")
    print(f"mesh: {n_dev} devices")

    # --- sharded frontend over a frame batch
    rs = np.random.default_rng(0)
    frames = np.stack([np.roll(textured_scene(96, 128), 3 * i, axis=1)
                       for i in range(2 * n_dev)])

    # --- distributed BA on a synthetic scene
    n_cams, n_lms = 6, 48
    lms = rs.uniform(-1, 1, (n_lms, 3)) + [0, 0, 5.0]
    cams = np.zeros((n_cams, 6))
    cams[:, 3] = np.linspace(-1, 1, n_cams)
    intr = np.array([300.0, 300.0, 64.0, 48.0])
    ci = np.repeat(np.arange(n_cams), n_lms).astype(np.int32)
    li = np.tile(np.arange(n_lms), n_cams).astype(np.int32)
    # exact observations from ground truth, then perturb the initial state
    uv = project_points(
        torch.as_tensor(cams, dtype=torch.float32, device=dev),
        torch.as_tensor(lms, dtype=torch.float32, device=dev),
        torch.as_tensor(intr, dtype=torch.float32, device=dev),
        torch.from_numpy(ci).to(dev), torch.from_numpy(li).to(dev)
    ).cpu().numpy()
    cams_n = cams + rs.normal(0, 0.01, cams.shape)
    cams_n[0] = cams[0]
    lms_n = lms + rs.normal(0, 0.02, lms.shape)

    n_obs = (len(ci) // n_dev) * n_dev
    work = (frames, cams_n, lms_n, intr, ci[:n_obs], li[:n_obs], uv[:n_obs])
    if n_dev == 1:
        out = solve(make_mesh(1, device=dev), *work)
    else:
        out = spawn(solve, n_dev, work,
                    device=None if args.device is None else dev)[0]
    sim = out["sharded_all_pairs_match"][0].numpy()
    before, after = out["reproj_rmse"]
    print("frame-similarity matrix (mean min-hamming), first row:",
          np.round(sim[0, :6], 1))
    print(f"reproj RMSE before BA: {before:.3f} px")
    print(f"reproj RMSE after distributed BA: {after:.3f} px")
    return out


if __name__ == "__main__":
    main()
