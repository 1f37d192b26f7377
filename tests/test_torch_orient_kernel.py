"""ORB's orientation kernel (``ops/kernels/orient_kernel.py``,
``csrc/orient_kernel.cu``) on the CPU, where the kernel cannot run: a NumPy
model of the kernel's arithmetic (the keypoint's rounding, clamping and
wrap, each row moment built outward, the rows folded centre, +d, -d, in
f32) equal bit for bit to the twin's dense moment maps at the keypoints,
for u8 images and for f32 images whose sums round; the constants of the
CUDA source against the module's; the wrapper's argument checks, its
routing of CPU tensors to the twin and the IndexError it raises before a
launch where the twin's gather raises. The card tests
(``tests/test_torch_cuda.py``) hold the kernel itself to the twin."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from compv_tpu_torch.features import orb
from compv_tpu_torch.ops.kernels import _build
from compv_tpu_torch.ops.kernels import orient_kernel as ok

R = ok.RADIUS
SOURCE = Path(ok.__file__).resolve().parents[2] / "csrc" / "orient_kernel.cu"


def _index(v: np.float32, n: int) -> int:
    """The kernel's index_of: half to even, clamp min(max(i, 15), n - 16),
    from the end where negative."""
    i = min(max(int(np.rint(v)), R), n - 1 - R)
    return i + n if i < 0 else i


def _model_moments(img: np.ndarray, r: int, c: int):
    """(m10, m01) at (r, c) in the kernel's order, f32 throughout."""
    h, w = img.shape
    f = img.astype(np.float32)

    def at(i, j):
        return f[i, j] if 0 <= i < h and 0 <= j < w else np.float32(0)

    def line(d, by_rows):
        m = np.float32(0)
        for e in range(1, ok.HALF_WIDTHS[abs(d)] + 1):
            a = at(r + d, c + e) if by_rows else at(r + e, c + d)
            b = at(r + d, c - e) if by_rows else at(r - e, c + d)
            m = np.float32(m + np.float32(np.float32(e) * np.float32(a - b)))
        return m

    def fold(by_rows):
        out = line(0, by_rows)
        for d in range(1, R + 1):
            out = np.float32(np.float32(out + line(d, by_rows))
                             + line(-d, by_rows))
        return out

    return fold(True), fold(False)


def _image(dtype: str, h: int, w: int, seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    if dtype == "u8":
        return rs.integers(0, 256, (h, w)).astype(np.uint8)
    # fractions over four decades: the f32 sums round, so order shows
    return (rs.normal(100, 60, (h, w))
            * 10.0 ** rs.integers(-2, 2, (h, w))).astype(np.float32)


def _keypoints(h: int, w: int, seed: int, n: int = 24):
    """Points inside, at and beyond the clamp edges, and at .5."""
    rs = np.random.default_rng(seed + 100)
    x = np.concatenate([rs.uniform(0, w - 1, n),
                        [-40, 0, 14.5, 15.5, 16.5, w - 16.5, w - 15.5,
                         w + 40]]).astype(np.float32)
    y = np.concatenate([rs.uniform(0, h - 1, n),
                        [h + 40, 14.5, 15.5, 0, h - 16.5, -40, 16.5,
                         h - 15.5]]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("shape", [(64, 80), (31, 45), (20, 12), (8, 30)])
def test_model_of_the_kernel_equals_the_moment_maps(dtype, shape):
    h, w = shape
    img = _image(dtype, h, w, seed=h * w)
    x, y = _keypoints(h, w, seed=h + w)
    t = torch.from_numpy(img)
    m10_map = orb._m10_map(t)
    m01_map = orb._m10_map(t.T).T
    # the twin's gather indices, torch indexing and all
    xi = torch.from_numpy(x).round().to(torch.int64).clamp(R, w - 1 - R)
    yi = torch.from_numpy(y).round().to(torch.int64).clamp(R, h - 1 - R)
    want10 = m10_map[yi, xi].numpy()
    want01 = m01_map[yi, xi].numpy()
    got = np.array([_model_moments(img, _index(b, h), _index(a, w))
                    for a, b in zip(x, y)], np.float32)
    np.testing.assert_array_equal(got[:, 0].view(np.int32),
                                  want10.view(np.int32))
    np.testing.assert_array_equal(got[:, 1].view(np.int32),
                                  want01.view(np.int32))


def test_the_order_matters_for_f32_images():
    """The model's order is not the only one that sums to these maps by
    luck: a row-major sum over the disc differs on f32 fractions."""
    h, w = 64, 80
    img = _image("f32", h, w, seed=7)
    m10_map = orb._m10_map(torch.from_numpy(img)).numpy()
    differs = 0
    for r in range(R, h - R, 5):
        for c in range(R, w - R, 5):
            s = np.float32(0)
            for d in range(-R, R + 1):
                e = ok.HALF_WIDTHS[abs(d)]
                for dx in range(-e, e + 1):
                    s = np.float32(s + np.float32(np.float32(dx)
                                                  * img[r + d, c + dx]))
            differs += s != m10_map[r, c]
    assert differs > 0


def test_the_source_holds_the_modules_constants():
    src = SOURCE.read_text()
    table = re.search(r"kHalfWidth\[kRadius \+ 1\] = \{([^}]*)\}", src)
    assert tuple(int(v) for v in table.group(1).split(",")) == ok.HALF_WIDTHS
    assert ok.HALF_WIDTHS == (15, 14, 14, 14, 14, 14, 13, 13, 12, 12, 11, 10,
                              9, 7, 5, 0)
    assert re.search(r"constexpr int kRadius = (\d+);", src).group(1) == \
        str(R)
    rad2deg = re.search(r"kRad2Deg = (0x[0-9a-fp.+-]+)f;", src).group(1)
    assert float.fromhex(rad2deg) == ok._RAD2DEG
    assert "use_fast_math" not in src


def _args(h=40, w=48, k=6, seed=0):
    img = torch.from_numpy(_image("u8", h, w, seed))
    x, y = (torch.from_numpy(a[:k].copy()) for a in _keypoints(h, w, seed))
    valid = torch.from_numpy(np.arange(k) % 3 != 1)
    return img, x, y, valid


@pytest.mark.parametrize("case,err", [
    ("img is a numpy array", TypeError),
    ("img 3-D", ValueError),
    ("img complex", ValueError),
    ("img not contiguous", ValueError),
    ("x f64", ValueError),
    ("y i32", ValueError),
    ("valid u8", ValueError),
    ("x 2-D", ValueError),
    ("x not contiguous", ValueError),
    ("lengths differ", ValueError),
    ("img on the meta device", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, err):
    img, x, y, valid = _args()
    if case == "img is a numpy array":
        img = img.numpy()
    elif case == "img 3-D":
        img = img[None]
    elif case == "img complex":
        img = img.to(torch.complex64)
    elif case == "img not contiguous":
        img = torch.from_numpy(_image("u8", 40, 96, 0))[:, ::2]
    elif case == "x f64":
        x = x.double()
    elif case == "y i32":
        y = y.to(torch.int32)
    elif case == "valid u8":
        valid = valid.to(torch.uint8)
    elif case == "x 2-D":
        x = x[:, None]
    elif case == "x not contiguous":
        x = torch.cat([x, x])[::2]
    elif case == "lengths differ":
        y = y[:-1]
    else:
        img = img.to("meta")
    before = _build.launch_counts()
    with pytest.raises(err):
        ok.patch_orientation(img, x, y, valid)
    assert _build.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32, torch.int16,
                                   torch.float64])
def test_wrapper_routes_cpu_tensors_to_the_twin(dtype):
    img, x, y, valid = _args(64, 80, k=12, seed=3)
    img = (img.to(dtype) * 3 - 100) if dtype != torch.uint8 else img
    before = _build.launch_counts()
    got = ok.patch_orientation(img, x, y, valid)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, ok._orientation_ref(img, x, y, valid))
    assert torch.equal(orb.patch_orientation(img, x, y, valid), got)
    assert not got[~valid].any()
    assert ((got >= 0) & (got < 360)).all()
    assert _build.launch_counts() == before  # the twin launches nothing
    empty = torch.empty(0)
    assert ok.patch_orientation(img, empty, empty,
                                empty.bool()).shape == (0,)


def test_orb_keeps_the_twin_under_its_names():
    assert orb._m10_map is ok._m10_map
    assert "patch_orientation" in orb.__all__


@pytest.mark.parametrize("h", [0, 1, 7, 8, 15, 16, 30, 31])
def test_gather_check_raises_where_the_twin_raises(h):
    for w in (0, 3, 7, 8, 9, 16, 30, 31, 40):
        img = torch.zeros((h, w), dtype=torch.uint8)
        x = y = torch.full((3,), 5.0)
        valid = torch.ones(3, dtype=torch.bool)
        try:
            ok._orientation_ref(img, x, y, valid)
            twin = None
        except IndexError:
            twin = IndexError
        try:
            ok._check_gather(h, w)
            check = None
        except IndexError:
            check = IndexError
        assert check is twin, (h, w)
