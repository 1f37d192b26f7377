"""SLAM/SfM frontend pair (mirror of ``compv_tpu/slam/frontend.py``).

The reference's object-recognition sample chain
(samples/object_recognition/main.cxx:92-220): ORB detect/describe on both
images -> brute-force KNN-2 Hamming match -> Lowe ratio test (0.67) ->
RANSAC homography. Runs on the device of the input images; every output
shape follows from the config, so nothing waits on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from compv_tpu_torch.calib.homography import HomographyConfig, find_homography
from compv_tpu_torch.features.orb import OrbConfig, OrbResult, orb_detect_describe
from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test

__all__ = ["FrontendConfig", "PairResult", "match_pair", "detect_describe"]


@dataclass(frozen=True)
class FrontendConfig:
    orb: OrbConfig = OrbConfig()
    homography: HomographyConfig = HomographyConfig()
    ratio: float = 0.67       # samples/object_recognition/main.cxx:185


class PairResult(NamedTuple):
    h: torch.Tensor              # (3,3) homography img1 -> img2
    num_matches: torch.Tensor    # ratio-test survivors
    num_inliers: torch.Tensor
    kp1_count: torch.Tensor
    kp2_count: torch.Tensor


def detect_describe(img: torch.Tensor,
                    config: FrontendConfig = FrontendConfig()) -> OrbResult:
    return orb_detect_describe(img, config.orb)


def match_pair(img1: torch.Tensor, img2: torch.Tensor,
               config: FrontendConfig = FrontendConfig()) -> PairResult:
    r1 = orb_detect_describe(img1, config.orb)
    r2 = orb_detect_describe(img2, config.orb)
    m = knn_match(r1.descriptors, r2.descriptors,
                  r1.keypoints.valid, r2.keypoints.valid, k=2)
    ok = ratio_test(m, config.ratio)

    src = torch.stack([r1.keypoints.x, r1.keypoints.y], dim=1)
    tidx = m.train_idx[0].to(torch.int64)
    dst = torch.stack([r2.keypoints.x[tidx], r2.keypoints.y[tidx]], dim=1)

    hres = find_homography(src, dst, ok, config.homography)
    return PairResult(h=hres.h,
                      num_matches=ok.sum().to(torch.int32),
                      num_inliers=hres.num_inliers,
                      kp1_count=r1.keypoints.count().to(torch.int32),
                      kp2_count=r2.keypoints.count().to(torch.int32))
