"""End-to-end incremental monocular SfM over an image sequence (mirror of
``compv_tpu/slam/sfm.py``).

ORB frontend -> descriptor matching -> essential-matrix bootstrap -> PnP
registration of the later frames -> two-view triangulation against each
track's first registered view -> local bundle adjustment after every frame
-> a final global BA, an outlier prune and a re-solve -> the trajectory,
scored as scale-aligned ATE against the ground truth (``slam/evaluate.py``).
The goldens are the reference's: ``goldens/sfm.json``,
``goldens/sfm_long.json`` and ``goldens/sfm_128.json``.

Per-frame and per-pair compute (ORB, KNN matching, the two RANSACs,
triangulation, BA) runs on ``device``; the sequence loop and the track
bookkeeping are host numpy, copied from the reference, because its
decisions are made on the host there too.

``render_orbit_sequence`` renders the benchmark sequence: two textured
fronto-parallel planes seen by an orbiting camera with exact ground-truth
poses.

The numpy-in entry points (``render_orbit_sequence``, ``run_sfm``,
``resume_sfm``, ``sfm_ate``) take a ``device``, the card by default; they
raise where there is none and never fall back to the CPU.

``resume_sfm(mesh=...)`` finishes a run on a process group
(``parallel.mesh.FrameMesh``) of any size, whatever the size it was
checkpointed under: the state is the replicated parameters and the
observation buffers, padded to a multiple of the group's size with
invalid entries and sharded over its ranks by the final BA
(``parallel.sharded.distributed_ba_solve``) with the configured solver.
"""
from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from compv_tpu_torch.calib.epipolar import (EssentialConfig, find_essential,
                                            triangulate_points)
from compv_tpu_torch.calib.pnp import PnpConfig, solve_pnp
from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
from compv_tpu_torch.image.remap import warp_perspective
from compv_tpu_torch.io.serialize import load_checkpoint, save_checkpoint
from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
from compv_tpu_torch.slam.ba import (BAConfig, BAProblem, ba_residuals,
                                     ba_solve, reproj_rmse,
                                     rodrigues_to_matrix)
from compv_tpu_torch.slam.ba_schur import SchurConfig, ba_solve_schur
from compv_tpu_torch.slam.evaluate import ate_rmse

__all__ = ["SfmConfig", "SfmResult", "render_orbit_sequence", "run_sfm",
           "resume_sfm", "sfm_ate"]

log = logging.getLogger(__name__)

# the state a checkpoint holds, with its dtypes
STATE_DTYPES = {"cams": torch.float32, "landmarks": torch.float32,
                "lm_valid": torch.bool, "ob_ci": torch.int32,
                "ob_li": torch.int32, "ob_uv": torch.float32,
                "ob_ok": torch.bool, "k": torch.float32,
                "n_tracks": torch.int32, "n_obs": torch.int32}


def _device(device) -> torch.device:
    return require_cuda() if device is None else torch.device(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# --------------------------------------------------------- synthetic sequence

def _plane_texture(h: int, w: int, seed: int, bg: bool) -> np.ndarray:
    """Corner-rich, locally unique 8-bit texture: overlapping random
    rectangles of random intensity over a low-frequency ramp."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 110 + 40 * np.sin(xx / 61.0) + 30 * np.cos(yy / 53.0)
    n_rects = (h * w) // 300
    for _ in range(n_rects):
        cy = int(rs.integers(0, h - 4))
        cx = int(rs.integers(0, w - 4))
        rh = int(rs.integers(4, 18))
        rw = int(rs.integers(4, 18))
        img[cy:cy + rh, cx:cx + rw] = rs.uniform(10, 245)
    return np.clip(img, 0, 255).astype(np.uint8)


def _look_at(center: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->camera rotation for a camera at ``center`` looking at
    ``target`` (camera z forward, y down)."""
    f = target - center
    f = f / np.linalg.norm(f)
    up = np.array([0.0, -1.0, 0.0])
    r_ = np.cross(up, f)
    r_ = r_ / np.linalg.norm(r_)
    u = np.cross(f, r_)
    return np.stack([r_, u, f])


def render_orbit_sequence(n_frames: int = 8, h: int = 240, w: int = 320,
                          seed: int = 7, device=None):
    """A camera arcing past two textured fronto-parallel planes (z=5 front
    patch, z=8 background), warped on ``device``. Returns (frames (N,H,W)
    u8, gt_centers (N,3) f64, K (3,3) f32), numpy."""
    dev = _device(device)
    f = 0.9 * w
    k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]], np.float32)
    planes = [
        (8.0, (-10.0, 10.0), (-7.5, 7.5), _plane_texture(760, 1000, seed, True)),
        (5.0, (-2.2, 1.4), (-1.8, 1.2), _plane_texture(420, 500, seed + 1, False)),
    ]
    t = np.linspace(0.0, 1.0, n_frames)
    centers = np.stack([1.6 * np.sin(t * 0.9), 0.35 * np.sin(t * 1.7),
                        0.8 * t], axis=1)
    target = np.array([0.0, 0.0, 6.5])
    textures = [(torch.from_numpy(tex).to(dev),
                 torch.full(tex.shape, 255, dtype=torch.uint8, device=dev))
                for _, _, _, tex in planes]

    frames = []
    for i in range(n_frames):
        r = _look_at(centers[i], target)
        tv = -r @ centers[i]
        img = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for (depth, (xa, xb), (ya, yb), tex), (tex_t, ones_t) in zip(
                planes, textures):
            th, tw = tex.shape
            hp = k @ np.stack([r[:, 0], r[:, 1], depth * r[:, 2] + tv], axis=1)
            a = np.array([[(xb - xa) / (tw - 1), 0, xa],
                          [0, (yb - ya) / (th - 1), ya],
                          [0, 0, 1.0]])
            h_img2tex = torch.tensor(np.linalg.inv(hp @ a), dtype=torch.float32,
                                     device=dev)
            warped = warp_perspective(tex_t, h_img2tex, h, w).to(torch.float32)
            m = warp_perspective(ones_t, h_img2tex, h, w).to(
                torch.float32) / 255.0
            img = img * (1 - m) + warped * m
        frames.append(_np(img.clamp(0, 255).to(torch.uint8)))
    return np.stack(frames), centers, k


# ----------------------------------------------------------------- pipeline

@dataclass(frozen=True)
class SfmConfig:
    orb: OrbConfig = OrbConfig(max_features=512, levels=4)
    essential: EssentialConfig = EssentialConfig(num_hypotheses=512,
                                                 threshold=1e-4)
    pnp: PnpConfig = PnpConfig(num_hypotheses=256, threshold=1e-4)
    ba: BAConfig = BAConfig(iterations=12, cg_iterations=30, robust_delta=3.0)
    local_ba: BAConfig = BAConfig(iterations=5, cg_iterations=25,
                                  robust_delta=3.0)
    ratio: float = 0.8
    solver: str = "cg"              # "cg" (matrix-free GN) | "schur"
                                    # (slam/ba_schur.py); both apply the
                                    # robust_delta IRLS whitening
    local_window: int | None = None  # windowed local BA: only cameras in
                                    # [i-window, i] move, older ones freeze
                                    # and anchor the gauge and the map
    checkpoint_every: int | None = None  # also checkpoint every N frames
                                    # (requires checkpoint_dir)
    max_landmarks: int = 4096
    max_obs: int = 16384            # fixed observation capacity
    min_bootstrap_flow: float = 0.05  # median (0,b) match flow, fraction of
                                      # width, before the pair can bootstrap
    min_parallax_deg: float = 0.6   # reject low-parallax triangulations
    prune_px: float = 4.0           # drop observations with post-BA residual
                                    # above this, then re-solve


class SfmResult(NamedTuple):
    positions: np.ndarray       # (N, 3) estimated camera centers
    cameras: np.ndarray         # (N, 6) [rvec|tvec] world->camera
    landmarks: np.ndarray       # (L, 3) world points (padded)
    landmark_valid: np.ndarray  # (L,) bool
    reproj_before: float        # px RMSE entering BA
    reproj_after: float         # px RMSE after BA
    num_tracks: int
    num_obs: int
    frame_stats: list           # per-frame dicts: PnP inliers, map points


def _match_step(desc1, valid1, desc2, valid2, ratio: float):
    m = knn_match(desc1, desc2, valid1, valid2, k=2)
    return m.train_idx[0], m.distance[0], ratio_test(m, ratio)


def _triangulate_pair(cam1, cam2, px1, px2, kinv):
    """Two-view triangulation with known poses: normalize the pixels, move
    to cam1's frame (relative pose), DLT-triangulate, map to the world.
    Returns (points, both depths > 0.05, cos of the parallax angle)."""
    r1 = rodrigues_to_matrix(cam1[:3])
    r2 = rodrigues_to_matrix(cam2[:3])
    t1, t2 = cam1[3:], cam2[3:]
    r_rel = r2 @ r1.T
    t_rel = t2 - r_rel @ t1

    def norm(p):
        ph = torch.cat([p, torch.ones((p.shape[0], 1), dtype=p.dtype,
                                      device=p.device)], dim=1)
        q = ph @ kinv.T
        return q[:, :2] / q[:, 2:3]

    pts_c1 = triangulate_points(r_rel, t_rel, norm(px1), norm(px2))
    pts_w = (pts_c1 - t1) @ r1          # R1^T (Xc - t1), row-vector form
    z1 = pts_c1[:, 2]
    z2 = (pts_c1 @ r_rel.T + t_rel)[:, 2]
    v1 = pts_w - (-r1.T @ t1)
    v2 = pts_w - (-r2.T @ t2)
    cosang = (v1 * v2).sum(dim=1) / (
        torch.linalg.vector_norm(v1, dim=1)
        * torch.linalg.vector_norm(v2, dim=1)).clamp_min(1e-12)
    return pts_w, (z1 > 0.05) & (z2 > 0.05), cosang


def _dedup_matches(tidx: np.ndarray, dist: np.ndarray, ok: np.ndarray
                   ) -> np.ndarray:
    """One-to-one matches: among queries hitting the same train index keep
    the smallest distance. Returns the refined ok mask."""
    ok = ok.copy()
    order = np.argsort(dist, kind="stable")
    seen = set()
    for q in order:
        if not ok[q]:
            continue
        t = int(tidx[q])
        if t in seen:
            ok[q] = False
        else:
            seen.add(t)
    return ok


def _problem(cams, landmarks, intr, ci, li, uv, ok, dev) -> BAProblem:
    return BAProblem(
        cameras=torch.as_tensor(cams, dtype=torch.float32, device=dev),
        landmarks=torch.as_tensor(landmarks, dtype=torch.float32, device=dev),
        intrinsics=intr, cam_idx=torch.as_tensor(ci, device=dev),
        lm_idx=torch.as_tensor(li, device=dev),
        uv=torch.as_tensor(uv, device=dev),
        valid=torch.as_tensor(ok, device=dev))


def _solver_config(cfg: BAConfig, solver: str):
    """``cfg``, or its ``SchurConfig`` where the solver is Schur."""
    if solver == "schur":
        return SchurConfig(iterations=cfg.iterations, damping=cfg.damping,
                           robust_delta=cfg.robust_delta)
    return cfg


def _solve(prob: BAProblem, cfg: BAConfig, solver: str, cam_mask=None):
    if solver == "schur":
        return ba_solve_schur(prob, _solver_config(cfg, solver),
                              cam_mask=cam_mask)[0]
    return ba_solve(prob, cfg, cam_mask=cam_mask)[0]


def _intrinsics(k: np.ndarray, dev) -> torch.Tensor:
    return torch.tensor([k[0, 0], k[1, 1], k[0, 2], k[1, 2]],
                        dtype=torch.float32, device=dev)


def run_sfm(frames: np.ndarray, k: np.ndarray,
            config: SfmConfig = SfmConfig(),
            checkpoint_dir: str | None = None, device=None) -> SfmResult:
    """Incremental SfM over (N, H, W) u8 frames with intrinsics K on
    ``device`` (the card by default). Frame 0 is the world origin; the
    global scale is arbitrary (monocular): evaluate with scale-aligned ATE.

    With ``checkpoint_dir``, the mid-sequence state (poses, landmarks,
    observation buffers) is saved after registration and before the final
    global BA (and every ``config.checkpoint_every`` frames), the point
    ``resume_sfm`` recovers from."""
    dev = _device(device)
    n_frames = len(frames)
    kj = torch.as_tensor(np.asarray(k), dtype=torch.float32, device=dev)
    kinv = torch.linalg.inv_ex(kj).inverse

    # --- frontend: detect + track
    obs = []   # per frame: (x, y, valid, desc, valid on the device)
    for i in range(n_frames):
        r = orb_detect_describe(torch.as_tensor(frames[i], device=dev),
                                config.orb)
        obs.append((_np(r.keypoints.x), _np(r.keypoints.y),
                    _np(r.keypoints.valid), r.descriptors, r.keypoints.valid))

    cap = config.orb.max_features
    track_of = np.full((n_frames, cap), -1, np.int64)   # kp -> track id
    pair_matches: List[np.ndarray] = []
    n_tracks = 0
    parent = []                                          # union-find

    def find(tr: int) -> int:
        while parent[tr] != tr:
            parent[tr] = parent[parent[tr]]
            tr = parent[tr]
        return tr

    def matched_pairs(a: int, b: int) -> np.ndarray:
        tidx, dist, ok = _match_step(obs[a][3], obs[a][4], obs[b][3],
                                     obs[b][4], config.ratio)
        tidx, dist, ok = _np(tidx), _np(dist), _np(ok)
        ok = _dedup_matches(tidx, dist, ok)
        qs = np.nonzero(ok)[0]
        return np.stack([qs, tidx[qs]], axis=1)

    for i in range(1, n_frames):
        m = matched_pairs(i - 1, i)
        for q, t in m:
            tr = track_of[i - 1, q]
            if tr < 0:
                tr = n_tracks
                parent.append(tr)
                n_tracks += 1
                track_of[i - 1, q] = tr
            track_of[i, t] = tr
        pair_matches.append(m)
        # skip-pair (i-2, i): longer tracks couple the structure across
        # frames
        if i >= 2:
            for q, t in matched_pairs(i - 2, i):
                ta, tb = track_of[i - 2, q], track_of[i, t]
                if ta >= 0 and tb < 0:
                    track_of[i, t] = ta
                elif ta < 0 and tb >= 0:
                    track_of[i - 2, q] = tb
                elif ta >= 0 and tb >= 0 and find(ta) != find(tb):
                    parent[find(ta)] = find(tb)          # merge tracks

    for fi in range(n_frames):
        for kp in range(cap):
            if track_of[fi, kp] >= 0:
                track_of[fi, kp] = find(track_of[fi, kp])

    # --- bootstrap pair: frame 0 against the first frame with enough median
    # flow (the essential-matrix bootstrap needs real parallax)
    w_img = frames.shape[2]
    boot_flow = config.min_bootstrap_flow * w_img

    def merge_matches_into_tracks(a: int, bb: int, m: np.ndarray):
        nonlocal n_tracks
        for q, t in m:
            ta, tb_ = track_of[a, q], track_of[bb, t]
            if ta >= 0 and tb_ < 0:
                track_of[bb, t] = ta
            elif ta < 0 and tb_ >= 0:
                track_of[a, q] = tb_
            elif ta < 0 and tb_ < 0:
                tr = n_tracks
                parent.append(tr)
                n_tracks += 1
                track_of[a, q] = tr
                track_of[bb, t] = tr
            elif find(ta) != find(tb_):
                parent[find(ta)] = find(tb_)

    b, m0b = 1, pair_matches[0]
    for j in range(1, n_frames):
        m = pair_matches[0] if j == 1 else matched_pairs(0, j)
        if len(m) < 30:
            break           # matching against frame 0 is degrading: stop
        if j > 1:
            merge_matches_into_tracks(0, j, m)
        b, m0b = j, m
        flow = float(np.median(np.hypot(
            obs[j][0][m[:, 1]] - obs[0][0][m[:, 0]],
            obs[j][1][m[:, 1]] - obs[0][1][m[:, 0]])))
        if flow >= boot_flow:
            break

    for fi in range(n_frames):
        live = track_of[fi] >= 0
        track_of[fi, live] = [find(t) for t in track_of[fi, live]]

    # --- bootstrap: essential matrix on the pair (0, b)
    pad = cap
    src = np.zeros((pad, 2), np.float32)
    dst = np.zeros((pad, 2), np.float32)
    msk = np.zeros((pad,), bool)
    nm = len(m0b)
    src[:nm] = np.stack([obs[0][0][m0b[:, 0]], obs[0][1][m0b[:, 0]]], axis=1)
    dst[:nm] = np.stack([obs[b][0][m0b[:, 1]], obs[b][1][m0b[:, 1]]], axis=1)
    msk[:nm] = True
    eres = find_essential(torch.from_numpy(src).to(dev),
                          torch.from_numpy(dst).to(dev), kj,
                          torch.from_numpy(msk).to(dev), config.essential)
    cams = np.zeros((n_frames, 6), np.float32)
    cams[b, :3] = _np(eres.rvec)
    cams[b, 3:] = _np(eres.tvec)

    # landmarks from the bootstrap triangulation (world = cam0 frame)
    lm_cap = config.max_landmarks
    landmarks = np.zeros((lm_cap, 3), np.float32)
    lm_valid = np.zeros((lm_cap,), bool)
    lm_of_track = np.full((n_tracks + 1,), -1, np.int64)
    n_lms = 0
    pts = _np(eres.points3d)
    inl = _np(eres.inliers)
    min_cos = np.cos(np.deg2rad(config.min_parallax_deg))
    for j in range(nm):
        if not inl[j] or n_lms >= lm_cap:
            continue
        tr = track_of[0, m0b[j, 0]]
        if tr < 0 or lm_of_track[tr] >= 0:
            continue
        landmarks[n_lms] = pts[j]
        lm_valid[n_lms] = True
        lm_of_track[tr] = n_lms
        n_lms += 1

    # first registered observation of each track: the wide-baseline anchor
    tr_first_frame = np.full((n_tracks + 1,), -1, np.int64)
    tr_first_kp = np.zeros((n_tracks + 1,), np.int64)

    def note_first_obs(fi: int):
        kps = np.nonzero(track_of[fi] >= 0)[0]
        trs = track_of[fi, kps]
        new = tr_first_frame[trs] < 0
        tr_first_frame[trs[new]] = fi
        tr_first_kp[trs[new]] = kps[new]

    registered = np.zeros((n_frames,), bool)
    registered[0] = registered[b] = True
    note_first_obs(0)
    note_first_obs(b)

    # --- fixed-capacity BA buffers
    oc = config.max_obs
    ob_ci = np.zeros((oc,), np.int32)
    ob_li = np.zeros((oc,), np.int32)
    ob_uv = np.zeros((oc, 2), np.float32)
    ob_ok = np.zeros((oc,), bool)
    intr = _intrinsics(np.asarray(k), dev)

    obs_x = np.stack([o[0] for o in obs])    # (F, cap) keypoint tables
    obs_y = np.stack([o[1] for o in obs])

    def rebuild_obs() -> int:
        """Fill the padded buffers with every (registered frame, landmark)
        observation of the track tables, frame-major; returns the count."""
        ob_ok[:] = False
        sub = np.where(registered[:, None], track_of, -1)
        fis, kps = np.nonzero(sub >= 0)
        trs = sub[fis, kps]
        lms = lm_of_track[trs]
        sel = (lms >= 0) & lm_valid[np.maximum(lms, 0)]
        fis, kps, lms = fis[sel], kps[sel], lms[sel]
        cnt = len(fis)
        if cnt > oc:
            warnings.warn(
                f"obs buffer saturated: {cnt} observations > max_obs={oc}; "
                f"dropping {cnt - oc} BA constraints — raise SfmConfig."
                f"max_obs", RuntimeWarning, stacklevel=2)
            fis, kps, lms = fis[:oc], kps[:oc], lms[:oc]
            cnt = oc
        ob_ci[:cnt] = fis
        ob_li[:cnt] = lms
        ob_uv[:cnt, 0] = obs_x[fis, kps]
        ob_uv[:cnt, 1] = obs_y[fis, kps]
        ob_ok[:cnt] = True
        return cnt

    def run_ba(cfg: BAConfig, frame_lo: int | None = None):
        """Solve BA over the buffers and write cams / landmarks back.
        ``frame_lo`` is the sliding window: cameras < frame_lo freeze, and
        the observations of one more window of frozen frames stay in the
        solve as anchors that hold the window to the map."""
        nonlocal cams
        cmask = None
        ok = ob_ok
        if frame_lo is not None:
            win = config.local_window or n_frames
            ok = ob_ok & (ob_ci >= max(frame_lo - win, 0))
            cmask = torch.from_numpy(np.arange(n_frames) >= frame_lo).to(dev)
        solved = _solve(_problem(cams, landmarks, intr, ob_ci, ob_li, ob_uv,
                                 ok, dev), cfg, config.solver, cmask)
        cams = _np(solved.cameras).copy()
        landmarks[:] = _np(solved.landmarks)

    def checkpoint(n_obs: int):
        save_checkpoint(checkpoint_dir, n_frames, {
            "cams": cams, "landmarks": landmarks, "lm_valid": lm_valid,
            "ob_ci": ob_ci, "ob_li": ob_li, "ob_uv": ob_uv, "ob_ok": ob_ok,
            "k": np.asarray(k, np.float32),
            "n_tracks": np.array([n_tracks], np.int32),
            "n_obs": np.array([n_obs], np.int32)})

    # polish the two-view bootstrap before the first PnP
    rebuild_obs()
    run_ba(config.local_ba)

    # --- register the remaining frames with PnP, extend the map
    p3 = np.zeros((pad, 3), np.float32)
    p2 = np.zeros((pad, 2), np.float32)
    stats_of = {b: {"map_pts": nm, "pnp_inliers": int(eres.num_inliers)}}
    for i in [f for f in range(1, n_frames) if f != b]:
        xs, ys = obs[i][0], obs[i][1]
        p3[:] = 0.0
        p2[:] = 0.0
        pm = np.zeros((pad,), bool)
        trs_i = track_of[i]
        kp_sel = np.nonzero(trs_i >= 0)[0]
        lms_i = lm_of_track[trs_i[kp_sel]]
        ok_i = (lms_i >= 0) & lm_valid[np.maximum(lms_i, 0)]
        kp_sel, lms_i = kp_sel[ok_i][:pad], lms_i[ok_i][:pad]
        cnt = len(kp_sel)
        p3[:cnt] = landmarks[lms_i]
        p2[:cnt, 0] = xs[kp_sel]
        p2[:cnt, 1] = ys[kp_sel]
        pm[:cnt] = True
        if cnt < 8:
            # too few map points: constant-velocity guess from the nearest
            # registered predecessors
            prev = [f for f in range(i) if registered[f]]
            if len(prev) >= 2:
                cams[i] = 2 * cams[prev[-1]] - cams[prev[-2]]
            else:
                cams[i] = cams[prev[-1]] if prev else 0.0
            stats_of[i] = {"map_pts": cnt, "pnp_inliers": 0}
        else:
            pres = solve_pnp(torch.from_numpy(p3).to(dev),
                             torch.from_numpy(p2).to(dev), kj,
                             torch.from_numpy(pm).to(dev), config.pnp)
            cams[i, :3] = _np(pres.rvec)
            cams[i, 3:] = _np(pres.tvec)
            stats_of[i] = {"map_pts": cnt,
                           "pnp_inliers": int(pres.num_inliers)}
        registered[i] = True

        # triangulate the unlandmarked tracks seen in frame i against their
        # first registered observation, the widest baseline available
        kps_i = np.nonzero(track_of[i] >= 0)[0]
        trs_i = track_of[i, kps_i]
        f0s = tr_first_frame[trs_i]
        cand = (lm_of_track[trs_i] < 0) & (f0s >= 0) & (f0s != i)
        for f0 in np.unique(f0s[cand]):
            rows = kps_i[cand & (f0s == f0)][:pad]
            trs_r = track_of[i, rows]
            kp0 = tr_first_kp[trs_r]
            nn = len(rows)
            px1 = np.zeros((pad, 2), np.float32)
            px2 = np.zeros((pad, 2), np.float32)
            px1[:nn] = np.stack([obs_x[f0, kp0], obs_y[f0, kp0]], axis=1)
            px2[:nn] = np.stack([obs_x[i, rows], obs_y[i, rows]], axis=1)
            pts_w, depth_ok, cosang = _triangulate_pair(
                torch.from_numpy(cams[f0]).to(dev),
                torch.from_numpy(cams[i]).to(dev),
                torch.from_numpy(px1).to(dev), torch.from_numpy(px2).to(dev),
                kinv)
            pts_w = _np(pts_w)
            good = _np(depth_ok) & (_np(cosang) < min_cos)
            for j in range(nn):
                if not good[j] or n_lms >= lm_cap:
                    continue
                tr = trs_r[j]
                if lm_of_track[tr] >= 0:
                    continue   # another row of this batch claimed the track
                landmarks[n_lms] = pts_w[j]
                lm_valid[n_lms] = True
                lm_of_track[tr] = n_lms
                n_lms += 1
        note_first_obs(i)

        # local BA: everything registered so far, or the sliding window
        if i % 16 == 0:
            log.info("sfm: registered frame %d/%d (landmarks=%d, obs~%d)",
                     i, n_frames, n_lms, int(ob_ok.sum()))
        rebuild_obs()
        lo = None if config.local_window is None else \
            max(i - config.local_window, 0)
        run_ba(config.local_ba, frame_lo=lo)
        if (checkpoint_dir is not None and config.checkpoint_every
                and i % config.checkpoint_every == 0):
            checkpoint(int(ob_ok.sum()))

    frame_stats = [stats_of[i] for i in sorted(stats_of)]
    # --- final global BA + outlier prune + re-solve
    n_obs = rebuild_obs()
    if checkpoint_dir is not None:
        checkpoint(n_obs)
    return _finalize_sfm(cams, landmarks, lm_valid, ob_ci, ob_li, ob_uv,
                         ob_ok, intr, config, n_tracks, n_obs, frame_stats)


def _finalize_sfm(cams, landmarks, lm_valid, ob_ci, ob_li, ob_uv, ob_ok,
                  intr, config: SfmConfig, n_tracks: int, n_obs: int,
                  frame_stats: list, mesh=None) -> SfmResult:
    """Final global BA, prune of the observations with a residual above
    ``config.prune_px``, re-solve, camera centers. Runs on ``intr``'s
    device. With a ``mesh`` each BA is ``distributed_ba_solve`` over its
    ranks, by ``config.solver``: CG steps or Schur steps. The reference
    runs CG steps there whatever the solver; at the 128-frame golden's
    Schur configuration 10 CG steps leave the trajectory where the
    checkpoint had it, 3x the golden's ATE. The ranks split the buffer's
    rows up to its last valid observation, padded to a multiple of the
    mesh's size (the reference splits the whole padded buffer, whose valid
    rows all lie at its front: its first rank would hold every
    observation)."""
    dev = intr.device
    n_frames = cams.shape[0]
    ob_ok = np.array(ob_ok)

    def solve(c, lm):
        if mesh is None:
            return _solve(_problem(c, lm, intr, ob_ci, ob_li, ob_uv, ob_ok,
                                   dev), config.ba, config.solver)
        from compv_tpu_torch.parallel.sharded import distributed_ba_solve

        used = int(np.flatnonzero(ob_ok)[-1]) + 1 if ob_ok.any() else 0
        m = used + (-used % mesh.size)

        def rows(a, fill=0):
            a = np.asarray(a)[:m]
            return np.concatenate([a, np.full((m - len(a),) + a.shape[1:],
                                              fill, a.dtype)])

        prob = _problem(c, lm, intr, rows(ob_ci), rows(ob_li), rows(ob_uv),
                        rows(ob_ok, False), dev)
        return distributed_ba_solve(
            prob, mesh, _solver_config(config.ba, config.solver))[0]

    before = float(reproj_rmse(_problem(cams, landmarks, intr, ob_ci, ob_li,
                                        ob_uv, ob_ok, dev)))
    solved = solve(cams, landmarks)
    r = _np(ba_residuals(solved.cameras, solved.landmarks, solved))
    m = min(len(r), len(ob_ok))
    ob_ok[:m] &= np.linalg.norm(r[:m], axis=1) <= config.prune_px
    solved = solve(_np(solved.cameras), _np(solved.landmarks))
    after = float(reproj_rmse(solved))

    cams_f = _np(solved.cameras)
    rms = _np(rodrigues_to_matrix(solved.cameras[:, :3]))
    centers = np.zeros((n_frames, 3))
    for i in range(n_frames):
        centers[i] = -rms[i].T @ cams_f[i, 3:]
    return SfmResult(positions=centers, cameras=cams_f,
                     landmarks=_np(solved.landmarks),
                     landmark_valid=np.array(lm_valid),
                     reproj_before=before, reproj_after=after,
                     num_tracks=n_tracks, num_obs=n_obs,
                     frame_stats=frame_stats)


def resume_sfm(checkpoint, config: SfmConfig = SfmConfig(),
               device=None, mesh=None) -> SfmResult:
    """Finish an SfM run from its mid-sequence state: the final global BA,
    the prune and the re-solve. ``checkpoint`` is the path of a checkpoint
    that ``run_sfm(..., checkpoint_dir=...)`` wrote, or such a state as a
    dict of tensors (``interop.sfm_state_from_numpy`` makes one from the
    JAX package's checkpoint). With ``mesh`` (a ``FrameMesh``, called by
    every rank) the final BA runs distributed over its ranks, on
    ``mesh.device``, whatever group size wrote the checkpoint."""
    dev = mesh.device if mesh is not None else _device(device)
    st = load_checkpoint(checkpoint) if isinstance(checkpoint, str) \
        else checkpoint
    st = {name: _np(torch.as_tensor(st[name]).to(dtype))
          for name, dtype in STATE_DTYPES.items()}
    return _finalize_sfm(st["cams"], st["landmarks"], st["lm_valid"],
                         st["ob_ci"], st["ob_li"], st["ob_uv"], st["ob_ok"],
                         _intrinsics(st["k"], dev), config,
                         int(st["n_tracks"].ravel()[0]),
                         int(st["n_obs"].ravel()[0]), [], mesh=mesh)


def sfm_ate(frames: np.ndarray, gt_centers: np.ndarray, k: np.ndarray,
            config: SfmConfig = SfmConfig(), device=None):
    """run_sfm and the scale-aligned ATE RMSE against the ground truth.
    Returns (ate, result)."""
    dev = _device(device)
    res = run_sfm(frames, k, config, device=dev)
    ate = float(ate_rmse(
        torch.as_tensor(res.positions, dtype=torch.float32, device=dev),
        torch.as_tensor(gt_centers, dtype=torch.float32, device=dev),
        with_scale=True))
    return ate, res
