"""Sharded pipelines over a process group: detect, all-pairs matching and
distributed BA (mirror of ``compv_tpu/parallel/sharded.py``).

Every function takes the global batch and is called collectively by all
ranks of ``mesh``; rank r computes its contiguous rows (frames or
observations) and every rank returns the same global result:

  * frames sharded over the ranks, ORB on each rank's frames (K1 runs on
    this path, once per pyramid level per frame), each result field
    all-gathered;
  * all-pairs matching against the all-gathered descriptor set, or the ring
    form: descriptor blocks travel the ring (``ring_shift``), so a rank
    holds one block besides its own at a time;
  * distributed BA: parameters replicated, observations sharded; the
    reference's psums are ordered sums (``_collectives.ordered_sum``), so
    two runs at one world size are bit-identical; or the CG state sharded,
    gathered before J v and reduce-scattered after J^T u
    (``ba_step_reduce_scatter``).
"""
from __future__ import annotations

import torch

from compv_tpu_torch.features.orb import OrbConfig, OrbResult, \
    orb_detect_describe
from compv_tpu_torch.core.types import Keypoints
from compv_tpu_torch.matchers.bruteforce import hamming_distance_matrix
from compv_tpu_torch.parallel._collectives import all_gather_cat, ring_shift
from compv_tpu_torch.parallel.mesh import FrameMesh, RowSharding
from compv_tpu_torch.slam.ba import (BAConfig, BAProblem, _tables, ba_step,
                                     ba_step_reduce_scatter)
from compv_tpu_torch.slam.ba_schur import (SchurConfig, _schur_tables,
                                           ba_step_schur,
                                           max_obs_per_landmark)

__all__ = ["sharded_detect", "sharded_orb_detect", "sharded_all_pairs_match",
           "ring_all_pairs_match", "distributed_ba_solve",
           "make_distributed_ba_step", "make_distributed_schur_step"]


def sharded_detect(images: torch.Tensor, mesh: FrameMesh, threshold: int = 20,
                   max_features: int = 256):
    """(F, H, W) u8 frames -> per-frame (x, y, strength, valid, desc): the
    single-level configuration of ``sharded_orb_detect``."""
    cfg = OrbConfig(max_features=max_features, threshold=threshold,
                    levels=1, subpixel=False)
    res = sharded_orb_detect(images, mesh, cfg)
    kp = res.keypoints
    return kp.x, kp.y, kp.strength, kp.valid, res.descriptors


def sharded_orb_detect(images: torch.Tensor, mesh: FrameMesh,
                       config: OrbConfig | None = None) -> OrbResult:
    """(F, H, W) u8 frames -> the full ORB pipeline of each frame
    (``features.orb.orb_detect_describe``), fields stacked to (F, ...).
    Each rank runs its F / D frames on ``mesh.device``, one at a time; the
    fields are all-gathered. F must split evenly over the ranks."""
    config = config or OrbConfig()
    local = RowSharding(mesh).shard(images).to(mesh.device)
    res = [orb_detect_describe(img, config) for img in local]
    kp = Keypoints(*[torch.stack([getattr(r.keypoints, f) for r in res])
                     for f in Keypoints._fields])
    desc = torch.stack([r.descriptors for r in res])
    return OrbResult(
        keypoints=Keypoints(*[all_gather_cat(f, mesh) for f in kp]),
        descriptors=all_gather_cat(desc, mesh))


def _pair_sim(d1, v1, d2, v2) -> torch.Tensor:
    """Mean-of-min Hamming distance from one descriptor set (K, B) bits to
    each set of a block (n, K, B): (n,) f32. The int minima are summed,
    cast to f32 and divided by the count, as the reference does; every step
    before the division is exact."""
    n, k = d2.shape[0], d2.shape[1]
    dist = hamming_distance_matrix(d1, d2.reshape(n * k, -1)).reshape(
        -1, n, k).permute(1, 0, 2)                         # (n, K, K)
    big = 1 << 30
    dist = torch.where(v2[:, None, :], dist, big)
    mins = dist.min(dim=2).values                          # (n, K)
    hit = v1[None, :] & (mins < big)
    total = torch.where(hit, mins, 0).sum(dim=1)
    cnt = hit.sum(dim=1).clamp_min(1)
    return total.to(torch.float32) / cnt.to(torch.float32)


def _block_sims(local_d, local_v, blk_d, blk_v) -> torch.Tensor:
    """(fl, n) similarities of each local frame to each frame of a block."""
    return torch.stack([_pair_sim(d, v, blk_d, blk_v)
                        for d, v in zip(local_d, local_v)])


def sharded_all_pairs_match(desc: torch.Tensor, valid: torch.Tensor,
                            mesh: FrameMesh) -> torch.Tensor:
    """(F, F) mean-of-min descriptor distances between frames (desc (F, K,
    B) bits, valid (F, K)): each rank matches its frames against the
    all-gathered set, and the rows are all-gathered."""
    sh = RowSharding(mesh)
    local_d = sh.shard(desc).to(mesh.device)
    local_v = sh.shard(valid).to(mesh.device)
    all_d = all_gather_cat(local_d, mesh)
    all_v = all_gather_cat(local_v, mesh)
    return all_gather_cat(_block_sims(local_d, local_v, all_d, all_v), mesh)


def ring_all_pairs_match(desc: torch.Tensor, valid: torch.Tensor,
                         mesh: FrameMesh) -> torch.Tensor:
    """``sharded_all_pairs_match`` with the descriptors exchanged around a
    ring instead of all-gathered: at step s each rank matches its frames
    against the block that came from rank (r - s) mod D, then passes it to
    rank r + 1. A rank holds one block besides its own at a time."""
    sh = RowSharding(mesh)
    local_d = sh.shard(desc).to(mesh.device)
    local_v = sh.shard(valid).to(mesh.device)
    fl = local_d.shape[0]
    out = torch.zeros((fl, fl * mesh.size), dtype=torch.float32,
                      device=mesh.device)
    blk_d, blk_v = local_d, local_v
    for step in range(mesh.size):
        src = (mesh.rank - step) % mesh.size
        out[:, src * fl:(src + 1) * fl] = _block_sims(local_d, local_v,
                                                      blk_d, blk_v)
        if step + 1 < mesh.size:
            blk_d = ring_shift(blk_d, mesh)
            blk_v = ring_shift(blk_v, mesh)
    return all_gather_cat(out, mesh)


def _local_problem(prob: BAProblem, mesh: FrameMesh) -> BAProblem:
    """The problem on ``mesh.device`` with this rank's observations."""
    sh = RowSharding(mesh)
    dev = mesh.device
    return BAProblem(
        cameras=prob.cameras.to(dev), landmarks=prob.landmarks.to(dev),
        intrinsics=prob.intrinsics.to(dev),
        cam_idx=sh.shard(prob.cam_idx).to(dev),
        lm_idx=sh.shard(prob.lm_idx).to(dev),
        uv=sh.shard(prob.uv).to(dev), valid=sh.shard(prob.valid).to(dev))


def _global_result(prob: BAProblem, solved: BAProblem,
                   mesh: FrameMesh) -> BAProblem:
    """The global problem on ``mesh.device`` with the solved parameters."""
    dev = mesh.device
    return BAProblem(solved.cameras, solved.landmarks, solved.intrinsics,
                     prob.cam_idx.to(dev), prob.lm_idx.to(dev),
                     prob.uv.to(dev), prob.valid.to(dev))


def make_distributed_ba_step(mesh: FrameMesh, cfg: BAConfig = BAConfig(),
                             mode: str = "psum"):
    """A distributed damped-GN step ``step(prob, lam) -> (prob, lam,
    cost_before)``: parameters replicated, this rank's observations.
    ``mode="psum"``: every J / J^T product summed over the ranks, the CG
    state replicated (``ba_step(psum_axis=mesh)``); ``"reduce_scatter"``:
    the CG state sharded over the ranks (``ba_step_reduce_scatter``)."""
    if mode not in ("psum", "reduce_scatter"):
        raise ValueError(f"mode must be 'psum' or 'reduce_scatter': {mode!r}")

    def step(prob: BAProblem, lam: torch.Tensor):
        local = _local_problem(prob, mesh)
        lam = torch.as_tensor(lam, dtype=local.cameras.dtype,
                              device=mesh.device)
        if mode == "reduce_scatter":
            new, lam, cost = ba_step_reduce_scatter(local, lam, cfg, mesh)
        else:
            new, lam, cost = ba_step(local, lam, cfg, psum_axis=mesh)
        return _global_result(prob, new, mesh), lam, cost

    return step


def make_distributed_schur_step(mesh: FrameMesh, cfg=None,
                                max_obs_per_lm: int = 16):
    """A distributed Schur-complement step ``step(prob, lam)``: each rank
    assembles Hcc / Hll / the gradients and the W, Z chunks from its
    observations, summed over the ranks into the exact reduced camera
    system on every rank (``slam.ba_schur.ba_step_schur(psum_axis=mesh)``).
    ``max_obs_per_lm`` caps one landmark's observations on a rank (the
    global count is a safe cap)."""
    cfg = cfg or SchurConfig()

    def step(prob: BAProblem, lam: torch.Tensor):
        local = _local_problem(prob, mesh)
        lam = torch.as_tensor(lam, dtype=local.cameras.dtype,
                              device=mesh.device)
        new, lam, cost = ba_step_schur(local, lam, cfg, psum_axis=mesh,
                                       max_obs_per_lm=max_obs_per_lm)
        return _global_result(prob, new, mesh), lam, cost

    return step


def distributed_ba_solve(prob: BAProblem, mesh: FrameMesh,
                         cfg: BAConfig = BAConfig()):
    """``cfg.iterations`` distributed steps: psum CG steps for a
    ``BAConfig``, Schur steps for a ``SchurConfig`` (the reference takes a
    ``BAConfig`` only). A Schur step's per-landmark cap is this rank's own
    largest count (the sums over ranks do not depend on it): the (L, K)
    tables of a problem whose merged tracks give one landmark thousands of
    observations then hold 1 / D of the single process's. Returns
    (problem, the last step's cost before it), as the reference. This
    rank's observation tables are built once."""
    local = _local_problem(prob, mesh)
    if isinstance(cfg, SchurConfig):
        k = max_obs_per_landmark(local.lm_idx, local.valid,
                                 local.landmarks.shape[0])
        tables = _schur_tables(local, k)

        def step(p, lam):
            return ba_step_schur(p, lam, cfg, psum_axis=mesh,
                                 max_obs_per_lm=k, tables=tables)
    else:
        tables = _tables(local)

        def step(p, lam):
            return ba_step(p, lam, cfg, psum_axis=mesh, tables=tables)
    lam = torch.tensor(cfg.damping, dtype=local.cameras.dtype,
                       device=mesh.device)
    cost = torch.zeros((), dtype=local.cameras.dtype, device=mesh.device)
    for _ in range(cfg.iterations):
        local, lam, cost = step(local, lam)
    return _global_result(prob, local, mesh), cost
