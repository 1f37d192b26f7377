"""Port parity, rows 13, 16 and 17 of the slice: the brute-force matcher,
``slam/frontend.match_pair`` as a whole, and the interop helpers, against
``compv_tpu`` on the same numpy inputs (CPU, small size: 120x160 scene
paired with its roll by (4, 7), levels=3, max_features=256,
num_hypotheses=128). Also the package rules: the port imports neither JAX
nor ``compv_tpu``.

Tolerances, each with its reason:
* Hamming distances, KNN indices and distances, ratio-test and
  cross-check masks on equal descriptors: exact (integer arithmetic, the
  same tie rule);
* whole slice: equal keypoint counts (the detector is exact); matches
  within 2 % and inliers within 3 %, because a BRIEF bit may differ (see
  tests/test_torch_orb.py) and move one ratio-test decision (measured: one
  match and one inlier of 58 and 55 on the first pair, none on the
  second); H within 0.05 px on an interior grid (f32 RANSAC and eigh on
  other LAPACK/BLAS; measured 0.006 px).
"""
import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.calib.homography import HomographyConfig as JHomographyConfig
from compv_tpu.features import orb as jorb
from compv_tpu.features.fast import FastConfig as JFastConfig
from compv_tpu.matchers import bruteforce as jbf
from compv_tpu.slam import frontend as jfront
from compv_tpu_torch.interop import (config_from_reference,
                                     keypoints_from_numpy, keypoints_to_numpy)
from compv_tpu_torch.matchers import bruteforce as bf
from compv_tpu_torch.slam import frontend

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JCFG = jfront.FrontendConfig(orb=jorb.OrbConfig(max_features=256, levels=3),
                             homography=JHomographyConfig(num_hypotheses=128))


def _scene(h=120, w=160, seed=0):
    """Gradient + checkerboard patch + noise, the bench scene at small size."""
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 96 + 48 * np.sin(xx / 17.0) + 40 * np.cos(yy / 23.0)
    ch = ((xx // 24).astype(int) + (yy // 24).astype(int)) % 2
    base = np.where((xx > w * 0.2) & (xx < w * 0.8) & (yy > h * 0.2)
                    & (yy < h * 0.8), ch * 200.0 + 20, base)
    return np.clip(base + rs.normal(0, 2.0, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def descriptors():
    """Bit matrices with repeated rows, so that distance ties are common."""
    rs = np.random.default_rng(31)
    q = rs.integers(0, 2, (40, 256), dtype=np.uint8)
    t = np.concatenate([q[:10] ^ (rs.random((10, 256)) < 0.05),
                        rs.integers(0, 2, (25, 256)), q[:10]]).astype(np.uint8)
    t[30] = t[29]
    qv = rs.random(40) < 0.9
    tv = rs.random(45) < 0.9
    return q, t, qv, tv


# ---------------------------------------------------------------- row 13

def test_hamming_distance_matrix_exact(descriptors):
    q, t, _, _ = descriptors
    got = bf.hamming_distance_matrix(torch.from_numpy(q), torch.from_numpy(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jbf.hamming_distance_matrix(jnp.asarray(q), jnp.asarray(t))))


@pytest.mark.parametrize("k,masked", [(2, True), (2, False), (3, True)])
def test_knn_match_and_ratio_test_exact(descriptors, k, masked):
    q, t, qv, tv = descriptors
    jargs = (jnp.asarray(qv), jnp.asarray(tv)) if masked else (None, None)
    targs = (torch.from_numpy(qv), torch.from_numpy(tv)) if masked else (None, None)
    want = jbf.knn_match(jnp.asarray(q), jnp.asarray(t), *jargs, k=k)
    got = bf.knn_match(torch.from_numpy(q), torch.from_numpy(t), *targs, k=k)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(bf.ratio_test(got, 0.67).numpy(),
                                  np.asarray(jbf.ratio_test(want, 0.67)))


def test_match_bruteforce_cross_check_exact(descriptors):
    q, t, qv, tv = descriptors
    jcfg = jbf.MatcherConfig(knn=1, cross_check=True)
    want = jbf.match_bruteforce(jnp.asarray(q), jnp.asarray(t), jcfg,
                                jnp.asarray(qv), jnp.asarray(tv))
    got = bf.match_bruteforce(torch.from_numpy(q), torch.from_numpy(t),
                              bf.MatcherConfig(knn=1, cross_check=True),
                              torch.from_numpy(qv), torch.from_numpy(tv))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# ---------------------------------------------------------------- row 16

@pytest.mark.parametrize("seed,shift", [(0, (4, 7)), (3, (-2, 5))])
def test_match_pair_matches_reference(seed, shift):
    img1 = _scene(seed=seed)
    img2 = np.roll(img1, shift, (0, 1))
    want = jfront.match_pair(jnp.asarray(img1), jnp.asarray(img2), JCFG)
    got = frontend.match_pair(torch.from_numpy(img1), torch.from_numpy(img2),
                              config_from_reference(JCFG))
    assert int(got.kp1_count) == int(want.kp1_count)
    assert int(got.kp2_count) == int(want.kp2_count)
    wm, wi = int(want.num_matches), int(want.num_inliers)
    assert wm > 30 and wi > 0.5 * wm
    assert abs(int(got.num_matches) - wm) <= 0.02 * wm
    assert abs(int(got.num_inliers) - wi) <= 0.03 * wi
    gy, gx = np.mgrid[20:101:10, 20:141:10].astype(np.float64)
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])

    def project(h):
        q = np.asarray(h, np.float64) @ p
        return q[:2] / q[2]

    assert np.abs(project(got.h.numpy()) - project(want.h)).max() <= 0.05
    # and the slice recovers the roll itself
    moved = project(got.h.numpy()) - p[:2]
    assert np.abs(moved - np.array([[shift[1]], [shift[0]]])).max() <= 0.5


def test_detect_describe_is_orb():
    img = _scene(seed=1)
    cfg = config_from_reference(JCFG)
    a = frontend.detect_describe(torch.from_numpy(img), cfg)
    b = frontend.orb_detect_describe(torch.from_numpy(img), cfg.orb)
    assert torch.equal(a.descriptors, b.descriptors)
    assert all(torch.equal(x, y) for x, y in zip(a.keypoints, b.keypoints))


# ---------------------------------------------------------------- row 17

@pytest.mark.parametrize("ref", [JCFG, jorb.OrbConfig(), JHomographyConfig(seed=3),
                                 JFastConfig(threshold=40, n=12)])
def test_config_from_reference_field_by_field(ref):
    port = config_from_reference(ref)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]


def test_port_config_defaults_equal_reference():
    for ref_cls in (jfront.FrontendConfig, jorb.OrbConfig, JHomographyConfig,
                    JFastConfig):
        assert config_from_reference(ref_cls()) == type(
            config_from_reference(ref_cls()))()


def test_config_from_reference_rejects_unknown():
    with pytest.raises(TypeError):
        config_from_reference(jbf.MatcherConfig())


def test_keypoints_roundtrip():
    ref = jorb.orb_detect_describe(jnp.asarray(_scene(seed=2)),
                                   jorb.OrbConfig(max_features=64, levels=1))
    kp = keypoints_from_numpy(ref.keypoints)
    assert kp.level.dtype == torch.int32 and kp.valid.dtype == torch.bool
    back = keypoints_to_numpy(kp)
    for name in ref.keypoints._fields:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(ref.keypoints, name)))
    again = keypoints_from_numpy(back)
    assert all(torch.equal(x, y) for x, y in zip(kp, again))


# ---------------------------------------------------------------- package

def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(_ROOT, "compv_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    # the port's example programs, and their common.py
    examples = os.path.join(_ROOT, "examples_torch")
    programs = sorted(n for n in os.listdir(examples) if n.endswith(".py"))
    assert programs == sorted(
        n for n in os.listdir(os.path.join(_ROOT, "examples"))
        if n.endswith(".py"))
    files += [os.path.join(examples, n) for n in programs]
    # the slice-4, slice-5 and slice-6 modules are among them
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "parallel/_collectives.py",
                "parallel/sharded.py", "parallel/launch.py",
                "math/matrix.py", "math/ops.py", "math/pca.py",
                "image/integral.py", "image/morph.py", "image/color.py",
                "image/histogram.py", "image/threshold.py",
                "features/hog.py", "ml/knn.py", "ml/svm.py",
                "ml/__init__.py", "__init__.py", "config.py", "registry.py",
                "profiling.py", "native_rt.py", "io/__init__.py",
                "io/image_io.py", "io/exif.py", "io/video.py",
                "io/camera.py", "viz/__init__.py", "viz/text.py",
                "viz/draw.py", "viz/stream.py"):
        assert os.path.join(_ROOT, "compv_tpu_torch", rel) in files, rel
    # the measurement programs keep their own copies of bench.py's parts
    programs = [os.path.join(_ROOT, "bench_torch.py"),
                os.path.join(_ROOT, "scripts", "roofline_torch.py")]
    for path in files + programs:
        forbidden = ("jax", "jaxlib", "compv_tpu") + (
            ("bench",) if path in programs else ())
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in forbidden, (path, mod)
    assert "bench_torch" in set(_imported_modules(programs[1]))
