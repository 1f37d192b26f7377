"""Sequence pipelines: planar tracking, homography decomposition and a
keyframe store (mirror of ``compv_tpu/slam/pipeline.py``).

``track_planar_sequence`` matches every frame to the previous one (ORB,
KNN-2 Hamming with the ratio test, RANSAC homography: the port's
``knn_match``, ``ratio_test`` and ``find_homography``) and chains the
homographies to frame 0; where a pair has too few inliers it
re-localizes against the template. The loop is on the host, as the
reference's: it reads each pair's inlier count and homography there (one
wait for the device per frame), and every per-frame computation runs on
the frames' device. ORB runs the FAST kernel (K1) on each pyramid level
of each frame on the card.

Every public entry takes float64 as float32 and int64 as int32
(``core.types.at_x64_off``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from compv_tpu_torch.core.types import at_x64_off
from compv_tpu_torch.calib.homography import HomographyConfig, find_homography
from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.features.orb import (OrbConfig, OrbResult,
                                          orb_detect_describe)
from compv_tpu_torch.math.rotation import matrix_to_rodrigues
from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test

__all__ = ["PlanarTrackerConfig", "PlanarTrackResult", "track_planar_sequence",
           "KeyframeStore", "decompose_homography"]


@dataclass(frozen=True)
class PlanarTrackerConfig:
    orb: OrbConfig = OrbConfig(max_features=1000, levels=4)
    homography: HomographyConfig = HomographyConfig(num_hypotheses=256)
    ratio: float = 0.75
    min_inliers: int = 12


class PlanarTrackResult(NamedTuple):
    h_to_first: List[np.ndarray]   # per frame, the homography frame 0 -> t
    num_inliers: List[int]
    tracked: List[bool]


def _pair_homography(a: OrbResult, b: OrbResult, config: PlanarTrackerConfig):
    """Homography a -> b of the ratio-test matches, and its inlier count.
    The reference's jitted pair step passes no config to
    ``find_homography``, so neither does the port: its defaults hold."""
    m = knn_match(a.descriptors, b.descriptors, a.keypoints.valid,
                  b.keypoints.valid, k=2)
    ok = ratio_test(m, config.ratio)
    src = torch.stack([a.keypoints.x, a.keypoints.y], dim=1)
    t = m.train_idx[0].long()
    dst = torch.stack([b.keypoints.x[t], b.keypoints.y[t]], dim=1)
    res = find_homography(src, dst, ok)
    return res.h, res.num_inliers


def track_planar_sequence(frames, config: PlanarTrackerConfig =
                          PlanarTrackerConfig(), device=None
                          ) -> PlanarTrackResult:
    """Track a planar scene: frame 0 is the template, every frame is
    matched to the previous one and the homographies are chained to frame 0;
    where the inliers drop below ``min_inliers`` the frame is matched to
    the template instead. Frames are (H, W) u8 arrays or tensors; numpy
    frames go to ``device`` (the card by default), tensors stay where
    they are unless ``device`` is given."""
    dev = None if device is None else torch.device(device)
    hs = [np.eye(3)]
    inl = [0]
    tracked = [True]
    prev: Optional[OrbResult] = None
    first: Optional[OrbResult] = None
    h_acc = np.eye(3)
    for i, frame in enumerate(frames):
        if isinstance(frame, torch.Tensor):
            img = frame if dev is None else frame.to(dev)
        else:
            img = torch.as_tensor(np.asarray(frame),
                                  device=dev or require_cuda())
        res = orb_detect_describe(img, config.orb)
        if i == 0:
            first = prev = res
            continue
        h, n = _pair_homography(prev, res, config)
        n = int(n)
        good = n >= config.min_inliers
        if good:
            h_acc = h.cpu().numpy() @ h_acc
        else:
            h0, n0 = _pair_homography(first, res, config)
            n0 = int(n0)
            if n0 >= config.min_inliers:
                h_acc = h0.cpu().numpy()
                n, good = n0, True
        hs.append(h_acc / h_acc[2, 2])
        inl.append(n)
        tracked.append(good)
        prev = res
    return PlanarTrackResult(h_to_first=hs, num_inliers=inl, tracked=tracked)


@at_x64_off(floats=("h", "k"))
def decompose_homography(h: torch.Tensor, k: torch.Tensor):
    """Planar H = K (R + t n^T / d) K^-1 under a fronto-parallel prior,
    n = (0, 0, 1): returns (rvec, t / d, n). R is the nearest rotation to
    the normalized K^-1 H K (SVD, det +1), so the result does not depend on
    the signs the solver returns."""
    a = torch.linalg.inv(k) @ h @ k
    # normalize so that the middle singular value is 1
    a = a / torch.linalg.svdvals(a)[1]
    n = torch.tensor([0.0, 0.0, 1.0], dtype=h.dtype, device=h.device)
    u, _, vt = torch.linalg.svd(a)
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[:, :2], u[:, 2:] * torch.sign(det)], dim=1)
    r = u @ vt
    return matrix_to_rodrigues(r), (a - r) @ n, n


@dataclass
class KeyframeStore:
    """Fixed-capacity keyframe store: descriptors, keypoints, poses."""
    capacity: int
    descriptors: List[torch.Tensor] = field(default_factory=list)
    keypoints: List = field(default_factory=list)
    poses: List[np.ndarray] = field(default_factory=list)
    frame_ids: List[int] = field(default_factory=list)

    def add(self, frame_id: int, orb: OrbResult, pose_rt: np.ndarray) -> bool:
        if len(self.frame_ids) >= self.capacity:
            return False
        self.descriptors.append(orb.descriptors)
        self.keypoints.append(orb.keypoints)
        self.poses.append(np.asarray(pose_rt))
        self.frame_ids.append(frame_id)
        return True

    def __len__(self):
        return len(self.frame_ids)

    def stacked_descriptors(self):
        """((K, N, 256) descriptors, (K, N) valid) of the stored frames."""
        return (torch.stack(self.descriptors),
                torch.stack([kp.valid for kp in self.keypoints]))
