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
    before = _build.launch_counts()
    fast_kernel.fast_strengths_and_nms(torch.from_numpy(corner_img))
    assert _build.launch_counts() == before


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


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Threads that build one source take turns on its lock file: the
    compiler (here a stand-in that takes half a second) runs once, and
    every thread gets its library."""
    import concurrent.futures

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    runs = tmp_path / "runs"
    nvcc.write_text("#!/bin/sh\nsleep 0.5\necho run >> " + str(runs) + "\n"
                    "while [ \"$1\" != -o ]; do shift; done\ntouch \"$2\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: _build.build("fast_kernel"),
                              range(4)))
    assert runs.read_text().splitlines() == ["run"]
    assert len(set(paths)) == 1 and paths[0].exists()


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


# ---------------------------------------------------------------------------
# A numpy model of the Hopper kernel's arithmetic (csrc/fast_kernel.cu): two
# horizontally adjacent pixels as the 16-bit lanes of a 32-bit word, the
# windows on the raw circle pixels, three-way min / max trees, the
# opposite-pair early-out, and 32-bit adds and subtractions that must not
# carry from lane to lane. Held against the twin, exactly.

def _lanes(word):
    return ((word & 0xffff).astype(np.uint16).view(np.int16),
            (word >> 16).astype(np.uint16).view(np.int16))


def _pack(lo, hi):
    return (lo.view(np.uint16).astype(np.uint32)
            | (hi.view(np.uint16).astype(np.uint32) << 16))


def _lanewise(fn, *words):
    los, his = zip(*(_lanes(w) for w in words))
    return _pack(fn(*los).astype(np.int16), fn(*his).astype(np.int16))


def _min3(a, b, c):
    return _lanewise(lambda x, y, z: np.minimum(np.minimum(x, y), z), a, b, c)


def _max3(a, b, c):
    return _lanewise(lambda x, y, z: np.maximum(np.maximum(x, y), z), a, b, c)


def _min2(a, b):
    return _lanewise(np.minimum, a, b)


def _max2(a, b):
    return _lanewise(np.maximum, a, b)


def _arc_extreme(v, n, max_inside):
    """Md (``max_inside``) or Mb over packed words, by the kernel's tree."""
    in3, in2 = (_max3, _max2) if max_inside else (_min3, _min2)
    out3, out2 = (_min3, _min2) if max_inside else (_max3, _max2)
    m3 = [in3(v[k], v[(k + 1) % 16], v[(k + 2) % 16]) for k in range(16)]
    m = [in3(m3[k], m3[(k + 3) % 16], m3[(k + 6) % 16]) for k in range(16)]
    if n == 12:
        m = [in2(m[k], m3[(k + 9) % 16]) for k in range(16)]
    r = [out3(m[3 * k], m[3 * k + 1], m[3 * k + 2]) for k in range(5)]
    r.append(m[15])
    return out2(out3(r[0], r[1], r[2]), out3(r[3], r[4], r[5]))


def _kernel_model(img, threshold, n):
    """(strengths (H, W) int64, share of lanes whose arcs were skipped)."""
    h, w = img.shape
    we = w + (w % 2)
    padded = np.zeros((h + 6, we + 6), np.uint32)
    padded[3:3 + h, 3:3 + w] = img

    def pair_words(dy, dx):
        c = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + we]
        return c[:, 0::2] | (c[:, 1::2] << 16)

    v = [pair_words(dy, dx) for dy, dx in fast.CIRCLE_OFFSETS]
    p = pair_words(0, 0)
    t2 = np.uint32(threshold * 0x00010001)
    bias = np.uint32(0x01000100)
    hi8 = [_max2(v[k], v[k + 8]) for k in range(8)]
    lo8 = [_min2(v[k], v[k + 8]) for k in range(8)]
    a = _min2(_min3(_min3(hi8[0], hi8[1], hi8[2]),
                    _min3(hi8[3], hi8[4], hi8[5]), hi8[6]), hi8[7])
    b = _max2(_max3(_max3(lo8[0], lo8[1], lo8[2]),
                    _max3(lo8[3], lo8[4], lo8[5]), lo8[6]), lo8[7])
    with np.errstate(over="ignore"):     # uint32 wrap-around, as on the card
        pt = p + t2
        brighter = _max2(a, pt) ^ pt     # a lane is non-zero iff a > p + t
        darker = _min2(b + t2, p) ^ p    # a lane is non-zero iff b + t < p
        floor2 = bias + t2
        zb = _arc_extreme(v, n, False) + bias - p
        zd = p + bias - _arc_extreme(v, n, True)
    # per lane: a side's arcs count only where its test passed
    lane_b = _pack(*(np.where(x != 0, np.int16(-1), np.int16(0))
                     for x in _lanes(brighter)))
    lane_d = _pack(*(np.where(x != 0, np.int16(-1), np.int16(0))
                     for x in _lanes(darker)))
    # only interior pixels ask for arcs (the kernel's row and column masks)
    yy, xx = np.mgrid[0:h, 0:we]
    inside = ((yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3))
    inside2 = _pack(*(np.where(m, np.int16(-1), np.int16(0))
                      for m in (inside[:, 0::2], inside[:, 1::2])))
    lane_b, lane_d = lane_b & inside2, lane_d & inside2
    z = floor2
    z = _max2(z, (zb & lane_b) | (floor2 & ~lane_b))
    z = _max2(z, (zd & lane_d) | (floor2 & ~lane_d))
    with np.errstate(over="ignore"):
        s = z - floor2
    lo, hi = _lanes(s)
    out = np.zeros((h, we), np.int64)
    out[:, 0::2], out[:, 1::2] = lo, hi
    skipped = 1.0 - ((lane_b | lane_d) != 0).mean()
    return np.where(inside, out, 0)[:, :w], skipped


def _model_images():
    rs = np.random.default_rng(21)
    yy, xx = np.mgrid[0:41, 0:67]
    return {
        "random": rs.integers(0, 256, (41, 67), dtype=np.uint8),
        "checker_1": (((yy + xx) % 2) * 255).astype(np.uint8),
        "checker_3": (((yy // 3 + xx // 3) % 2) * 255).astype(np.uint8),
        "saturated": np.where(rs.random((41, 67)) < 0.5, 255, 0
                              ).astype(np.uint8),
        "corners": np.pad(np.full((20, 30), 240, np.uint8), 11,
                          constant_values=12),
    }


@pytest.mark.parametrize("n", [9, 12])
@pytest.mark.parametrize("threshold", [0, 20, 255])
@pytest.mark.parametrize("name", ["random", "checker_1", "checker_3",
                                  "saturated", "corners"])
def test_kernel_arithmetic_model_equals_twin(name, threshold, n):
    img = _model_images()[name]
    got, _ = _kernel_model(img, threshold, n)
    want = fast_kernel._strengths_ref(torch.from_numpy(img), threshold, n)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


def test_kernel_model_skips_flat_regions_and_not_noise():
    flat = np.full((40, 64), 100, np.uint8)
    flat[10:30, 20:44] += np.random.default_rng(3).integers(
        0, 5, (20, 24), dtype=np.uint8)
    assert _kernel_model(flat, 20, 9)[1] == 1.0
    noise = np.random.default_rng(4).integers(0, 256, (40, 64), dtype=np.uint8)
    assert _kernel_model(noise, 20, 9)[1] < 0.9


@pytest.mark.parametrize("threshold", [0, 20, 255])
def test_early_out_candidates_cover_every_corner(threshold):
    """The per-pixel test the wrapper exposes: no pixel outside the
    candidates has a strength, at N = 9 and 12."""
    for img in _model_images().values():
        t = torch.from_numpy(img)
        brighter, darker = fast_kernel.early_out_candidates(t, threshold)
        for n in (9, 12):
            s = fast_kernel._strengths_ref(t, threshold, n)
            assert not bool(((s > 0) & ~(brighter | darker)).any())


def test_early_out_counts_model_on_cpu():
    """A CPU tensor goes to the model of the kernel's geometry: every warp
    row of a flat image is skipped, none of a noisy one."""
    assert fast_kernel.geometry(720, 1282) == (64, 32, 62, 30)
    assert fast_kernel.geometry(412, 733) == (64, 16, 62, 14)
    _, str_h, out_w, out_h = fast_kernel.geometry(100, 200)
    # a tile row tests its interior image rows, ring rows included: rows
    # that two tile rows share are tested twice
    rows = sum(1 for by in range(-(-100 // out_h)) for sr in range(str_h)
               if 3 <= by * out_h - 1 + sr < 97)
    want = -(-200 // out_w) * rows
    flat = torch.full((100, 200), 90, dtype=torch.uint8)
    tested, skipped, brighter, darker = fast_kernel.early_out_counts(
        flat, 20, 9).tolist()
    assert tested == want > 4 * 94 and skipped == tested
    assert brighter == darker == 0
    noise = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (100, 200), dtype=np.uint8))
    tested, skipped, brighter, darker = fast_kernel.early_out_counts(
        noise, 20, 9).tolist()
    assert tested == want and skipped == 0
    assert brighter > 0.95 * want and darker > 0.95 * want


from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 255), min_size=16, max_size=16),
       st.integers(0, 255), st.integers(0, 255), st.sampled_from([9, 12]))
def test_early_out_lemma_on_random_circles(circle, p, t, n):
    """For N >= 9 every arc holds k or k + 8 for each k: a pixel whose
    opposite pairs fail both tests has strength 0, and the strength is
    max(Mb - p - t, p - t - Md, 0) with the windows on the raw pixels."""
    c = np.array(circle)
    arcs = [[c[(s + i) % 16] for i in range(n)] for s in range(16)]
    for arc_start in range(16):
        members = {(arc_start + i) % 16 for i in range(n)}
        assert all(k in members or k + 8 in members for k in range(8))
    brighter = max(min(v - p - t for v in arc) for arc in arcs)
    darker = max(min(p - t - v for v in arc) for arc in arcs)
    strength = max(brighter, darker, 0)
    mb = max(min(arc) for arc in arcs)
    md = min(max(arc) for arc in arcs)
    assert strength == max(mb - p - t, p - t - md, 0)
    a = min(max(c[k], c[k + 8]) for k in range(8))
    b = max(min(c[k], c[k + 8]) for k in range(8))
    if a <= p + t:
        assert brighter <= 0
    if b >= p - t:
        assert darker <= 0
    if a <= p + t and b >= p - t:
        assert strength == 0
