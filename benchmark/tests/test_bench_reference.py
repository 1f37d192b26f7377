"""The frozen reference agrees with the port's CPU path at small sizes
(only this test imports both)."""
import numpy as np
import pytest
import torch

from benchmark import roofline, scenes
from benchmark.reference import geometry, orb as ref_orb, sampling
from benchmark.reference.matcher import knn2_ratio
from benchmark.systems.frontend_pair import orb_numbers


def _img(seed, h=150, w=260):
    gen = scenes.device_generator(seed, "cpu")
    return scenes.object_scene(h, w, seed, gen, "cpu")


@pytest.mark.parametrize("levels,feats,seed", [(3, 300, 1), (4, 512, 2),
                                               (8, 400, 3)])
def test_orb_equals_the_port(levels, feats, seed):
    from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
    img = _img(seed, 300, 420)
    cfg = dict(max_features=feats, levels=levels, scale_factor=0.83,
               threshold=20, fast_n=9, blur_size=5, blur_sigma=2.0)
    port = orb_detect_describe(img, OrbConfig(**cfg))
    ref = ref_orb.orb(img, cfg)
    cand = port.keypoints._asdict() | {"descriptors": port.descriptors}
    assert orb_numbers([cand], [ref]) == {"kp_mismatch_pct": 0.0,
                                          "desc_bit_err_pct": 0.0}
    assert torch.equal(port.keypoints.orientation, ref["orientation"])
    low = ref_orb.orb(img, cfg, torch.bfloat16)
    assert orb_numbers([low], [ref])["kp_mismatch_pct"] > 10


def test_matcher_equals_the_port():
    from compv_tpu_torch.matchers.bruteforce import knn_match, ratio_test
    g = torch.Generator().manual_seed(4)
    q = (torch.rand((300, 256), generator=g) < 0.5).to(torch.uint8)
    t = (torch.rand((280, 256), generator=g) < 0.5).to(torch.uint8)
    t[:50] = q[:50] ^ (torch.rand((50, 256), generator=g) < 0.1).to(torch.uint8)
    t[60] = t[61]                                  # a tie
    qv = torch.rand(300, generator=g) < 0.9
    tv = torch.rand(280, generator=g) < 0.9
    m = knn_match(q, t, qv, tv, k=2)
    idx, dist, ok = knn2_ratio(q, qv, t, tv, 0.67, block=64)
    assert torch.equal(ok, ratio_test(m, 0.67))
    assert torch.equal(idx[ok], m.train_idx[0].long()[ok])


def test_sampling_equals_the_port():
    from compv_tpu_torch.calib.ransac import _masked_sample_idx
    mask = torch.rand(200, generator=torch.Generator().manual_seed(1)) < 0.7
    for seed, s, k in ((0, 512, 4), (3, 256, 6)):
        assert torch.equal(sampling.masked_sample_idx(seed, mask, s, k),
                           _masked_sample_idx(seed, mask, s, k).long())


def test_homography_follows_the_port():
    from compv_tpu_torch.calib.homography import find_homography
    rs = np.random.default_rng(5)
    h_true = scenes.similarity_about_centre(480, 640, 9.0, 1.1, 20.0, -15.0)
    src = rs.uniform(0, 640, (400, 2))
    dst = geometry.apply_h(h_true, src) + rs.normal(0, 0.7, (400, 2))
    dst[:80] = rs.uniform(0, 640, (80, 2))                    # outliers
    mask = torch.from_numpy(rs.random(400) < 0.95)
    s32 = torch.from_numpy(src).float()
    d32 = torch.from_numpy(dst).float()
    port = find_homography(s32, d32, mask)
    h, inl = geometry.find_homography(s32, d32, mask, 512, 30.0)
    corners = np.array([[0, 0], [640, 0], [640, 480], [0, 480]], float)
    gap = np.abs(geometry.apply_h(port.h.double().numpy(), corners)
                 - geometry.apply_h(h.numpy(), corners)).max()
    assert gap < 1e-2
    assert abs(int(inl.sum()) - int(port.num_inliers)) <= 1


def test_fast_stage_model():
    img = torch.zeros((40, 64), dtype=torch.uint8)
    img[10:30, 20:40] = 200
    nbytes, ops = roofline.fast_stage((img, 20, 9))
    n = 40 * 64
    assert nbytes == 9 * n
    b, d = (roofline.pairs(c) for c in roofline.early_out_candidates(img, 20))
    assert ops == {"int32": 18 * n + 40 * (b + d)} and b + d > 0
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    assert roofline.bound(nbytes, ops, peaks)["bound_by"] == "bytes"
