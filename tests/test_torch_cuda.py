"""The FAST kernel K1 on the card: kernel against its plain twin, exact, and
the port on CUDA against the port on CPU. Every test needs an NVIDIA GPU
and nvcc, and skips without them.

This file imports neither JAX nor ``compv_tpu``, so it runs on a machine
without them; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from compv_tpu_torch.features.fast import FastConfig, fast_detect
from compv_tpu_torch.features.orb import OrbConfig, orb_detect_describe
from compv_tpu_torch.ops.kernels import fast_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _scene(h, w, seed=0):
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > w * 0.2) & (xx < w * 0.8) & (yy > h * 0.2)
                    & (yy < h * 0.8), ch * 200.0 + 20, base)
    return np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (8, 32), (33, 47),
                                   (299, 401), (720, 1282)])
@pytest.mark.parametrize("threshold,n", [(20, 9), (40, 12)])
def test_kernel_equals_twin(dev, shape, threshold, n):
    img = torch.from_numpy(_scene(*shape)).to(dev)
    raw = fast_kernel._strengths_ref(img, threshold, n)
    sup = fast_kernel._nms_ref(raw)
    for nms, want in ((False, raw), (True, sup)):
        got = fast_kernel.fast_strengths_nms(img, threshold, n, nms, as_f32=True)
        assert torch.equal(got, want)
        got = fast_kernel.fast_strengths_nms(img, threshold, n, nms)
        assert torch.equal(got, want.to(torch.uint8))
    got_raw, got_sup = fast_kernel.fast_strengths_and_nms(img, threshold, n)
    assert torch.equal(got_raw, raw) and torch.equal(got_sup, sup)
    torch.cuda.synchronize()


def test_kernel_counts_its_launches(dev):
    img = torch.zeros((16, 16), dtype=torch.uint8, device=dev)
    before = fast_kernel.launches
    fast_kernel.fast_strengths_nms(img)
    fast_kernel.fast_strengths_and_nms(img)
    assert fast_kernel.launches == before + 2


def test_kernel_rejects_non_contiguous(dev):
    img = torch.zeros((16, 32), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        fast_kernel.fast_strengths_nms(img)


def test_fast_detect_cuda_equals_cpu(dev):
    img = _scene(240, 320, seed=4)
    cfg = FastConfig(max_features=4096)
    a = fast_detect(torch.from_numpy(img), cfg)
    b = fast_detect(torch.from_numpy(img).to(dev), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())


def test_orb_cuda_matches_cpu(dev):
    """Detector outputs exact; orientation and BRIEF within the cross-device
    ulp tolerances (atan2 / cos / sin of another math library)."""
    img = _scene(240, 320, seed=5)
    cfg = OrbConfig(max_features=500, levels=4)
    a = orb_detect_describe(torch.from_numpy(img), cfg)
    b = orb_detect_describe(torch.from_numpy(img).to(dev), cfg)
    for name in ("x", "y", "strength", "level", "size", "valid"):
        assert torch.equal(getattr(a.keypoints, name),
                           getattr(b.keypoints, name).cpu()), name
    d = (a.keypoints.orientation - b.keypoints.orientation.cpu()).abs()
    assert float(torch.minimum(d, 360 - d).max()) <= 1e-3
    assert float((a.descriptors != b.descriptors.cpu()).float().mean()) <= 1e-3
