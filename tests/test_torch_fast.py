"""Port parity, rows 10-11 of the slice: the FAST kernel module's plain twin
(what a CPU tensor runs) and ``features/fast.py`` against ``compv_tpu`` —
the XLA twin the JAX detector runs, the Pallas kernel K1 in interpret mode,
and the four locked FAST goldens. Exact everywhere: strengths are small
integers in both packages. The kernel itself is held against the twin on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.core.golden import keypoint_summary
from compv_tpu.features import fast as jfast
from compv_tpu.ops.pallas.fast_kernel import fast_strengths_nms_pallas
from compv_tpu_torch.features import fast
from compv_tpu_torch.interop import config_from_reference
from compv_tpu_torch.ops.kernels import _build, fast_kernel
from tests.fixtures import make_test_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corner_img():
    rs = np.random.default_rng(11)
    img = rs.integers(90, 110, (61, 83), dtype=np.uint8)
    img[10:20, 10:25] = 220
    img[30:40, 35:50] = 15
    img[44:58, 60:79] = 240
    img[24, 55] = 250
    return img


def test_circle_offsets_equal_reference():
    assert fast.CIRCLE_OFFSETS == jfast.CIRCLE_OFFSETS


@pytest.mark.parametrize("threshold,n", [(10, 9), (20, 9), (20, 12), (40, 12)])
def test_twin_strengths_equal_xla_twin(corner_img, threshold, n):
    want = np.asarray(jfast._strengths_f32(jnp.asarray(corner_img), threshold, n))
    got = fast_kernel._strengths_ref(torch.from_numpy(corner_img), threshold, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fast_kernel._nms_ref(got).numpy(),
                                  np.asarray(jfast._nms_f32(jnp.asarray(want))))


@pytest.mark.parametrize("nms,as_f32", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_wrapper_equals_pallas_interpret(corner_img, nms, as_f32):
    want = np.asarray(fast_strengths_nms_pallas(
        jnp.asarray(corner_img), 20, 9, nms=nms, interpret=True, as_f32=as_f32))
    got = fast_kernel.fast_strengths_nms(torch.from_numpy(corner_img), 20, 9,
                                         nms=nms, as_f32=as_f32)
    assert got.dtype == (torch.float32 if as_f32 else torch.uint8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_two_output_entry_equals_xla_twin():
    img = np.random.default_rng(12).integers(0, 256, (33, 47), dtype=np.uint8)
    raw, nms = fast_kernel.fast_strengths_and_nms(torch.from_numpy(img), 40, 12)
    want_raw = np.asarray(jfast._strengths_f32(jnp.asarray(img), 40, 12))
    np.testing.assert_array_equal(raw.numpy(), want_raw)
    np.testing.assert_array_equal(nms.numpy(),
                                  np.asarray(jfast._nms_f32(jnp.asarray(want_raw))))


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (6, 9)])
def test_tiny_images_match_reference(shape):
    img = np.full(shape, 200, np.uint8)
    img[shape[0] // 2, shape[1] // 2] = 0
    want = np.asarray(jfast._nms_f32(jfast._strengths_f32(jnp.asarray(img),
                                                         20, 9)))
    got = fast_kernel.fast_strengths_nms(torch.from_numpy(img), 20, 9,
                                         as_f32=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_do_not_count_launches(corner_img):
    before = fast_kernel.launches
    fast_kernel.fast_strengths_and_nms(torch.from_numpy(corner_img))
    assert fast_kernel.launches == before


@pytest.mark.parametrize("bad", [
    dict(img=torch.zeros((8, 8), dtype=torch.float32)),
    dict(img=torch.zeros((2, 8, 8), dtype=torch.uint8)),
    dict(img=torch.zeros((8, 16), dtype=torch.uint8)[:, ::2]),
    dict(img=torch.zeros((8, 8), dtype=torch.uint8, device="meta")),
    dict(img=torch.zeros((8, 8), dtype=torch.uint8), n=10),
    dict(img=torch.zeros((8, 8), dtype=torch.uint8), threshold=-1),
    dict(img=torch.zeros((8, 8), dtype=torch.uint8), threshold=2.5),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(threshold=20, n=9) | bad
    with pytest.raises(ValueError):
        fast_kernel.fast_strengths_nms(args["img"], args["threshold"], args["n"])
    with pytest.raises(ValueError):
        fast_kernel.fast_strengths_and_nms(args["img"], args["threshold"],
                                           args["n"])


def test_library_path_is_keyed_by_source():
    p = _build.library_path("fast_kernel")
    assert p.parent == _build.BUILD_DIR
    assert p.name.startswith("fast_kernel-") and p.suffix == ".so"
    assert p == _build.library_path("fast_kernel")


def test_fast_strengths_and_nms_match_reference():
    img = make_test_image(120, 160)
    s = fast.fast_strengths(torch.from_numpy(img), 20, 9)
    want = np.asarray(jfast.fast_strengths(jnp.asarray(img), 20, 9))
    np.testing.assert_array_equal(s.numpy(), want)
    np.testing.assert_array_equal(fast.fast_nms(s).numpy(),
                                  np.asarray(jfast.fast_nms(jnp.asarray(want))))


@pytest.mark.parametrize("n,thr,nms", [(9, 20, True), (9, 20, False),
                                       (12, 40, True), (9, 40, True)])
def test_fast_detect_goldens_and_reference(n, thr, nms):
    """The golden tuples of scripts/make_goldens.py:49-53, and field-by-field
    equality with the reference detector."""
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        golden = json.load(f)[f"fast{n}_thr{thr}_nms{int(nms)}"]
    img = make_test_image()
    jcfg = jfast.FastConfig(threshold=thr, n=n, nms=nms, max_features=8192)
    kp = fast.fast_detect(torch.from_numpy(img), config_from_reference(jcfg))
    assert keypoint_summary(kp) == golden
    ref = jfast.fast_detect(jnp.asarray(img), jcfg)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(kp, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
