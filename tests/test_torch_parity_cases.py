"""The cases of the port's differential sweep, and the means to run them.

Each case is one public function of ``compv_tpu`` (by module and name),
one input set made from a seed with numpy, and one value of an axis: a
dtype (u8, i8, u16, i16, u32, i32, f32, f64, where the reference takes
it) or a shape (1x1, odd sizes such as 7x9 and 17x23, empty point or
descriptor sets). ``tests/test_torch_parity_{math,image,geometry}.py`` run
each case through the reference and the port on the CPU;
``chip_smoke.py`` phase 24 loads this file by path and runs each case
through the port on the card and on the CPU. So this file imports only
numpy and torch (and the port, inside ``run``): the machine with the
card has no JAX.

Two outcomes agree when both raise the same exception class (the nearest
built-in class), or when both return the same structure with the same
dtypes and shapes, integer and bool results bit-equal and float results
within the case's tolerance (default 1e-5 relative and 1e-4 absolute).

The dtype contract: the port returns what the reference returns with
JAX's x64 off. A float64 input gives float32 results and an int64 input
int32 ones, as ``jnp.asarray`` makes them; the reference runs on
``jnp.asarray`` of each numpy input, as its own tests call it.

``BY_DESIGN`` lists each known difference with its reason;
``tests/test_torch_parity_cases.py::test_by_design_entries_still_differ``
(with the reference, in the parity files) checks that each still shows.
``NOT_SWEPT`` gives the reason for each public callable of the swept
modules that has no case.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
from typing import Callable, NamedTuple

import numpy as np
import torch

DTYPES = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16,
          "u32": np.uint32, "i32": np.int32, "f32": np.float32,
          "f64": np.float64}
INTS = ("u8", "i8", "u16", "i16", "u32", "i32")
FLOATS = ("f32", "f64")
ALL = INTS + FLOATS

# the swept modules of each package, under their shared relative names
SWEPT_PACKAGES = ("math", "ops", "image", "features", "matchers", "calib",
                  "slam")


# ------------------------------------------------------------ input specs

class Cfg(NamedTuple):
    """A config dataclass of either package, by module and class name."""
    module: str
    name: str
    fields: dict


class Tup(NamedTuple):
    """A NamedTuple of either package (Keypoints, Matches, Lines, BAProblem,
    PcaModel, PoseGraph), by module and class name; its fields are input
    specs."""
    module: str
    name: str
    fields: dict


class DType(NamedTuple):
    """A dtype argument, by its short name (``DTYPES``)."""
    name: str


def cfg(module: str, name: str, **fields) -> Cfg:
    return Cfg(module, name, fields)


def tup(module: str, name: str, **fields) -> Tup:
    return Tup(module, name, fields)


def convert(obj, array: Callable, resolve: Callable, dtype: Callable):
    """An input spec with each numpy array through ``array``, each
    ``Cfg`` / ``Tup`` built from ``resolve(module, name)`` and each
    ``DType`` through ``dtype``."""
    if isinstance(obj, np.ndarray):
        return array(obj)
    if isinstance(obj, (Cfg, Tup)):
        cls = resolve(obj.module, obj.name)
        fields = {k: convert(v, array, resolve, dtype)
                  for k, v in obj.fields.items()}
        return cls(**fields)
    if isinstance(obj, DType):
        return dtype(obj.name)
    if isinstance(obj, list):
        return [convert(v, array, resolve, dtype) for v in obj]
    if isinstance(obj, tuple):
        return tuple(convert(v, array, resolve, dtype) for v in obj)
    if isinstance(obj, dict):
        return {k: convert(v, array, resolve, dtype) for k, v in obj.items()}
    return obj


# ------------------------------------------------------------- the cases

class Case(NamedTuple):
    module: str                 # relative to the package: "math.ops"
    fn: str
    axis: str                   # "u16", "7x9", "empty", ...
    seed: int
    make: Callable              # rng -> (args, kwargs) of input specs
    rtol: float = 1e-5
    atol: float = 1e-4
    post: Callable | None = None    # numpy tree -> tree, both sides
    tag: str = ""               # tells apart two cases on one axis
    # (args, kwargs) -> the reference's inputs: its oracle where the
    # reference itself is at fault (REFERENCE_FAULTS)
    ref_inputs: Callable | None = None

    @property
    def id(self) -> str:
        tag = f",{self.tag}" if self.tag else ""
        return f"{self.module}.{self.fn}[{self.axis}{tag}]"

    def inputs(self):
        return self.make(np.random.default_rng(self.seed))


_SINK: list[Case] = []


def _add(module, fn, axis, make, seed=None, **kw):
    seed = len(_SINK) if seed is None else seed
    _SINK.append(Case(module, fn, axis, seed, make, **kw))


def values(rs, dt: str, shape, lo=None, hi=None):
    """Random values of dtype ``dt``: integers over the dtype's whole range
    (clipped to [lo, hi] when given), floats normal with scale 50 (uniform
    in [lo, hi) when given)."""
    np_dt = DTYPES[dt]
    if np.issubdtype(np_dt, np.integer):
        info = np.iinfo(np_dt)
        a = info.min if lo is None else max(lo, info.min)
        b = info.max if hi is None else min(hi, info.max)
        return rs.integers(a, b, size=shape, endpoint=True).astype(np_dt)
    if lo is None:
        return (rs.normal(size=shape) * 50).astype(np_dt)
    return rs.uniform(lo, hi, size=shape).astype(np_dt)


def pixels(rs, dt: str, shape):
    """An image of dtype ``dt`` with values in [0, 256): integers, or
    floats with fractions."""
    if dt in FLOATS:
        return rs.uniform(0, 255.99, size=shape).astype(DTYPES[dt])
    return rs.integers(0, 256, size=shape).astype(DTYPES[dt])


def sign_fix(*paths):
    """A ``post`` that flips each column (last axis -2 vectors) of the
    arrays at ``paths`` of a result tuple so its largest entry is
    positive: eigen- and singular vectors are defined up to sign."""
    def post(tree):
        named = isinstance(tree, tuple)         # (NamedTuple name, fields)
        if named:
            name, fields = tree
            tree = list(fields.values())
        if not isinstance(tree, list):
            return tree
        tree = list(tree)
        for p, axis in paths:
            v = np.array(tree[p], np.float64)
            idx = np.argmax(np.abs(v), axis=axis)
            s = np.sign(np.take_along_axis(
                v, np.expand_dims(idx, axis), axis))
            s[s == 0] = 1
            tree[p] = (v * s).astype(tree[p].dtype)
        return (name, dict(zip(fields, tree))) if named else tree
    return post


# the case tables of each module group are filled by these functions, so a
# parity file (and phase 24) can take one group at a time
def _math_cases():
    shp = (7, 9)
    for dt in ALL:
        _add("math.ops", "add", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), values(rs, dt, shp)], {}))
        _add("math.ops", "add", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), 3], {}), tag="scalar")
        _add("math.ops", "sub", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), values(rs, dt, shp)], {}))
        _add("math.ops", "mul_elementwise", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), values(rs, dt, shp)], {}))
        for fn in ("abs_", "minmax", "relu", "tanh_activation",
                   "logistic_activation", "fast_exp"):
            _add("math.ops", fn, dt, lambda rs, dt=dt: (
                [values(rs, dt, shp)], {}))
        _add("math.ops", "clip", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), 3, 100], {}))
        _add("math.ops", "scale_values", dt, lambda rs, dt=dt: (
            [values(rs, dt, shp), 3], {}))
        for fn in ("hypot_", "fast_atan2_deg", "atan2_deg_exact"):
            _add("math.ops", fn, dt, lambda rs, dt=dt: (
                [values(rs, dt, shp), values(rs, dt, shp)], {}),
                rtol=1e-5, atol=1e-3)
        for target in ("u8", "i16", "u16", "i32", "f32"):
            _add("math.ops", "cast", dt, lambda rs, dt=dt, t=target: (
                [values(rs, dt, shp), DType(t)], {}), tag=target)
        _add("math.ops", "image_moments", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23))], {}), rtol=1e-5)
        _add("math.ops", "hu_moments", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23))], {}), rtol=1e-4)
    for shape in ((1, 1), (17, 23)):
        ax = f"{shape[0]}x{shape[1]}"
        _add("math.ops", "add", ax, lambda rs, s=shape: (
            [values(rs, "u8", s), values(rs, "u8", s)], {}))
        _add("math.ops", "minmax", ax, lambda rs, s=shape: (
            [values(rs, "i16", s)], {}))
        _add("math.ops", "image_moments", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s)], {"order": 3}))

    # matrix
    for dt in ALL:
        sq = lambda rs, dt=dt, n=3: values(rs, dt, (n, n), -9, 9)  # noqa
        _add("math.matrix", "trace", dt, lambda rs, sq=sq: ([sq(rs)], {}))
        _add("math.matrix", "determinant", dt,
             lambda rs, sq=sq: ([sq(rs)], {}), rtol=1e-5)
        _add("math.matrix", "is_symmetric", dt, lambda rs, dt=dt: (
            [_symmetric(values(rs, dt, (4, 4), 0, 9))], {}))
        _add("math.matrix", "is_symmetric", dt, lambda rs, dt=dt: (
            [values(rs, dt, (4, 4), 0, 9)], {}), tag="asym")
        _add("math.matrix", "transpose", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 5))], {}))
        _add("math.matrix", "mul_ab", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 4), -9, 9), values(rs, dt, (4, 2), -9, 9)],
            {}))
        _add("math.matrix", "mul_abt", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 4), -9, 9), values(rs, dt, (2, 4), -9, 9)],
            {}))
        _add("math.matrix", "mul_ata", dt, lambda rs, dt=dt: (
            [values(rs, dt, (5, 3), -9, 9)], {}))
        _add("math.matrix", "is_colinear_2d", dt, lambda rs, dt=dt: (
            [_line_points(rs, dt)], {}))
        _add("math.matrix", "inverse_diagonal", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 3), 1, 9)], {}), rtol=1e-5)
    for dt in FLOATS:
        _add("math.matrix", "mul_ag", dt, lambda rs, dt=dt: (
            [values(rs, dt, (4, 4), -9, 9), 1, 3, 0.6, 0.8], {}))
        _add("math.matrix", "mul_ga", dt, lambda rs, dt=dt: (
            [values(rs, dt, (4, 4), -9, 9), 0, 2, 0.6, -0.8], {}))
        _add("math.matrix", "rank", dt, lambda rs, dt=dt: (
            [(rs.normal(size=(6, 2)) @ rs.normal(size=(2, 4))).astype(
                DTYPES[dt])], {}))
        _add("math.matrix", "eigen_symm", dt, lambda rs, dt=dt: (
            [_symmetric(rs.normal(size=(4, 4)).astype(DTYPES[dt]))], {}),
            rtol=1e-4, post=sign_fix((1, 0)))
        _add("math.matrix", "svd", dt, lambda rs, dt=dt: (
            [rs.normal(size=(5, 3)).astype(DTYPES[dt])], {}), rtol=1e-4,
            post=sign_fix((0, 0), (2, 1)))
        _add("math.matrix", "pseudo_inverse", dt, lambda rs, dt=dt: (
            [rs.normal(size=(5, 3)).astype(DTYPES[dt])], {}), rtol=1e-4)
        _add("math.matrix", "inverse_3x3", dt, lambda rs, dt=dt: (
            [(rs.normal(size=(3, 3)) + 3 * np.eye(3)).astype(DTYPES[dt])],
            {}), rtol=1e-4)
    for n in (1, 2, 4):
        _add("math.matrix", "determinant", f"{n}x{n}", lambda rs, n=n: (
            [rs.normal(size=(n, n)).astype(np.float32)], {}), rtol=1e-4)
        _add("math.matrix", "trace", f"{n}x{n}", lambda rs, n=n: (
            [rs.normal(size=(n, n)).astype(np.float32)], {}))

    # distance, stats, transform, fit
    for dt in FLOATS + ("i32", "u8"):
        pts = lambda rs, dt=dt, n=9: values(rs, dt, (n, 2), 0, 60)  # noqa
        _add("math.distance", "dist_line", dt, lambda rs, pts=pts: (
            [pts(rs), 0.6, -0.8, 3.0], {}))
        _add("math.distance", "dist_parabola", dt, lambda rs, pts=pts: (
            [pts(rs), 0.01, -0.5, 3.0], {}))
        _add("math.distance", "dist_parabola", dt, lambda rs, pts=pts: (
            [pts(rs), 0.01, -0.5, 3.0], {"axis": "y"}), tag="y")
        _add("math.distance", "squared_l2", dt, lambda rs, dt=dt: (
            [values(rs, dt, (5, 4), 0, 20), values(rs, dt, (3, 4), 0, 20)],
            {}), rtol=1e-5, atol=1e-3)
        _add("math.distance", "l2", dt, lambda rs, dt=dt: (
            [values(rs, dt, (5, 4), 0, 20), values(rs, dt, (3, 4), 0, 20)],
            {}), rtol=1e-5, atol=1e-3)
        _add("math.stats", "hartley_normalize", dt, lambda rs, pts=pts: (
            [pts(rs), _mask(rs, 9)], {}), ref_inputs=_oracle(dt))
        _add("math.stats", "mse_2d", dt, lambda rs, pts=pts: (
            [pts(rs), pts(rs), _mask(rs, 9)], {}))
        _add("math.stats", "masked_mean", dt, lambda rs, pts=pts: (
            [pts(rs), _mask(rs, 9)[:, None]], {"axis": 0}))
        _add("math.stats", "masked_variance", dt, lambda rs, pts=pts: (
            [pts(rs), _mask(rs, 9)[:, None]], {"axis": 0}), rtol=1e-4)
        _add("math.transform", "to_homogeneous", dt, lambda rs, pts=pts: (
            [pts(rs)], {}))
        _add("math.transform", "homogeneous_to_cartesian_2d", dt,
             lambda rs, dt=dt: ([values(rs, dt, (3, 6), 1, 9)], {}))
        _add("math.transform", "perspective_2d", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 6), 1, 9), _homography(rs, dt)], {}))
        _add("math.transform", "apply_homography", dt, lambda rs, pts=pts,
             dt=dt: ([_homography(rs, dt), pts(rs)], {}), rtol=1e-5)
        _add("math.fit", "fit_line", dt, lambda rs, dt=dt: (
            [_noisy_line(rs, dt)], {"num_hypotheses": 32}), rtol=1e-4,
            atol=1e-3, post=_line_sign)
        _add("math.fit", "fit_parabola", dt, lambda rs, dt=dt: (
            [_noisy_parabola(rs, dt)], {"num_hypotheses": 32}), rtol=1e-4,
            atol=1e-3)
    for dt in ("u8", "u16", "i32"):
        _add("math.distance", "hamming_packed", dt, lambda rs, dt=dt: (
            [values(rs, dt, (6, 32), 0, 255), values(rs, dt, (32,), 0, 255)],
            {}))
        _add("math.distance", "hamming", dt, lambda rs, dt=dt: (
            [values(rs, dt, (6, 16), 0, 1), values(rs, dt, (16,), 0, 1)],
            {}))

    # pca
    for dt in FLOATS:
        _add("math.pca", "pca_compute", dt, lambda rs, dt=dt: (
            [rs.normal(size=(20, 5)).astype(DTYPES[dt]), 3], {}),
            rtol=1e-4, atol=1e-4, post=_pca_post)
        _add("math.pca", "pca_project", dt, lambda rs, dt=dt: (
            [_pca_model(rs), rs.normal(size=(6, 5)).astype(DTYPES[dt])],
            {}))
        _add("math.pca", "pca_backproject", dt, lambda rs, dt=dt: (
            [_pca_model(rs), rs.normal(size=(6, 3)).astype(DTYPES[dt])],
            {}))
    for dt in ("i32", "u8"):      # integer points, a float H
        _add("math.transform", "apply_homography", dt, lambda rs, dt=dt: (
            [_homography(rs, "f32"), values(rs, dt, (9, 2), 0, 60)], {}),
            tag="f32-h")


def _ops_cases():
    for dt in ("u8", "u16", "i32", "f32", "f64"):
        _add("ops.topk", "select_top_k", dt, lambda rs, dt=dt: (
            [values(rs, dt, (37,), 0, 9), 5], {"exact": True}))
        _add("ops.topk", "select_top_k_2d", dt, lambda rs, dt=dt: (
            [values(rs, dt, (7, 9), 0, 9), 6], {"exact": True}))
    _add("ops.topk", "select_top_k", "k>n", lambda rs: (
        [values(rs, "f32", (4,)), 5], {"exact": True}))
    for dt in ("u8", "i32", "u16", "i16"):
        _add("ops.bincount", "batched_weighted_bincount", dt,
             lambda rs, dt=dt: ([values(rs, dt, (3, 40), 0, 199),
                                 values(rs, "u8", (3, 40), 0, 1), 200],
                                {"chunk_a": 4}))
    for dt in ("u8", "i8", "u16", "u32", "i32"):
        _add("ops.bitops", "pack_bits_to_bytes", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 16), 0, 1)], {}))
        _add("ops.bitops", "unpack_bytes_to_bits", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 4))], {}))
        _add("ops.bitops", "popcount_bytes", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 4))], {}))
        for fn in ("bits_and", "bits_or", "bits_xor"):
            _add("ops.bitops", fn, dt, lambda rs, dt=dt: (
                [values(rs, dt, (3, 4)), values(rs, dt, (3, 4))], {}))
        _add("ops.bitops", "bits_not", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 4))], {}))
    for size, sigma in ((3, 0.8), (5, 2.0), (7, 1.5)):
        _add("ops.conv", "gaussian_kernel1d", f"{size}", lambda rs, s=size,
             g=sigma: ([s, g], {}))
        _add("ops.conv", "gaussian_kernel2d", f"{size}", lambda rs, s=size,
             g=sigma: ([s, g], {}))
        _add("ops.conv", "fixed_point_kernel", f"{size}", lambda rs, s=size:
             ([np.array([1, 4, 6, 4, 1][:s] + [0] * max(0, s - 5),
                        np.float32) / 16], {}))
    for dt in ("u8", "i16", "u16", "f32", "f64"):
        for shape in ((1, 1), (7, 9), (17, 23)):
            ax = f"{dt},{shape[0]}x{shape[1]}"
            _add("ops.conv", "gaussian_blur", ax, lambda rs, dt=dt, s=shape:
                 ([pixels(rs, dt, s)], {}), rtol=1e-5, atol=1e-3)
        _add("ops.conv", "convolve_separable", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), np.array([1, 2, 1], np.float32) / 4,
             np.array([1, 0, -1], np.float32)], {}), atol=1e-3)
        _add("ops.conv", "convolve_separable", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), np.array([1, 2, 1], np.float32) / 4,
             np.array([1, 0, -1], np.float32)], {"border": "replicate"}),
            atol=1e-3, tag="replicate")
        _add("ops.conv", "convolve2d", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), np.arange(9, dtype=np.float32
                                               ).reshape(3, 3) / 9], {}),
            atol=1e-3)
    for dt in ("u8", "f32"):
        for shape in ((1, 1), (7, 9), (17, 23)):
            ax = f"{dt},{shape[0]}x{shape[1]}"
            _add("ops.conv", "gaussian_blur_q16", ax, lambda rs, dt=dt,
                 s=shape: ([pixels(rs, dt, s)], {}))
            _add("ops.conv", "convolve_separable_q16", ax, lambda rs, dt=dt,
                 s=shape: ([pixels(rs, dt, s), (16384, 32768, 16384),
                            (21845, 21845, 21845)], {}))


def _image_cases():
    shapes = ((1, 1), (7, 9), (17, 23))
    rgb = lambda rs, dt, s=(7, 9), c=3: pixels(rs, dt, s + (c,))  # noqa
    for dt in ALL:
        for fn in ("rgb_to_gray", "bgr_to_gray", "rgb_to_yuv444",
                   "rgb_to_i420", "rgb_to_hsv", "rgb_to_hsl",
                   "rgb_to_rgb565", "split_channels", "to_gray"):
            _add("image.color", fn, dt, lambda rs, dt=dt: (
                [rgb(rs, dt, (6, 8))], {}))
        _add("image.color", "rgba_to_gray", dt, lambda rs, dt=dt: (
            [rgb(rs, dt, c=4)], {}))
        _add("image.color", "to_gray", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9))], {}), tag="gray")
        for fn in ("yuv_to_rgb", "yuv444_to_hsv"):
            _add("image.color", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (7, 9)) for _ in range(3)], {}))
        _add("image.color", "i420_to_rgb", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (6, 8)), pixels(rs, dt, (3, 4)),
             pixels(rs, dt, (3, 4))], {}))
        _add("image.color", "i422_to_rgb", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (6, 8)), pixels(rs, dt, (6, 4)),
             pixels(rs, dt, (6, 4))], {}))
        for fn in ("nv12_to_rgb", "nv21_to_rgb"):
            _add("image.color", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (6, 8)), pixels(rs, dt, (3, 8))], {}))
        for fn in ("yuyv_to_rgb", "uyvy_to_rgb"):
            _add("image.color", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (6, 16))], {}))
        _add("image.color", "merge_channels", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)) for _ in range(3)], {}))
        _add("image.color", "rgb565_to_rgb", dt, lambda rs, dt=dt: (
            [values(rs, dt, (6, 8), 0, 65535)], {}))

        for fn in ("histogram256", "equalize", "projection_x",
                   "projection_y", "otsu_value", "threshold_otsu"):
            _add("image.histogram" if "otsu" not in fn else
                 "image.threshold", fn, dt, lambda rs, dt=dt: (
                     [pixels(rs, dt, (17, 23))], {}))
        _add("image.histogram", "apply_lut256", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), values(rs, "f32", (256,), 0, 255)], {}))
        _add("image.threshold", "threshold_global", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), 100], {}))
        _add("image.threshold", "threshold_global", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), 100], {"maxval": 200, "inverse": True}),
            tag="inverse")
        _add("image.threshold", "threshold_adaptive", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23))], {}))
        _add("image.threshold", "threshold_wolf", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23))], {"block_size": 7}))
        for fn in ("erode", "dilate", "open_", "close_", "morph_gradient",
                   "top_hat", "black_hat"):
            _add("image.morph", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (17, 23))], {}))
        for fn in ("integral", "integral_squared"):
            _add("image.integral", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (7, 9))], {}))
        _add("image.integral", "box_mean_var", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23)), 5], {}))
        _add("image.integral", "box_sum", dt, lambda rs, dt=dt: (
            [values(rs, dt, (8, 10), 0, 99), 3], {}))
        for fn in ("scale_bilinear", "scale_bicubic", "scale_nearest"):
            _add("image.scale", fn, dt, lambda rs, dt=dt: (
                [pixels(rs, dt, (17, 23)), 11, 13], {}), atol=1e-3)
        for interp in ("bilinear", "bicubic", "nearest"):
            _add("image.scale", "scale", dt, lambda rs, dt=dt, i=interp: (
                [pixels(rs, dt, (7, 9)), 10, 5], {"interpolation": i}),
                tag=interp, atol=1e-3)
        _add("image.scale", "rotate_bilinear", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23)), 30.0], {}), atol=1e-3)
        _add("image.scale", "rotate_fast", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23)), np.array(30.0, np.float32)], {}))
        _add("image.remap", "remap_bilinear", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), values(rs, "f32", (5, 6), -1, 9),
             values(rs, "f32", (5, 6), -1, 7)], {}), atol=1e-3)
        _add("image.remap", "remap_nearest", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (7, 9)), values(rs, "f32", (5, 6), -1, 9),
             values(rs, "f32", (5, 6), -1, 7)], {}))
        _add("image.remap", "warp_perspective", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23)), _homography(rs, "f32"), 13, 11], {}),
            atol=1e-3)
        _add("image.remap", "warp_affine", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23)), _homography(rs, "f32")[:2], 13, 11],
            {}), atol=1e-3)
        _add("image.pyramid", "build_pyramid", dt, lambda rs, dt=dt: (
            [pixels(rs, dt, (17, 23))], {"levels": 3}), atol=1e-3)
    for shape in shapes:
        ax = f"{shape[0]}x{shape[1]}"
        for fn in ("histogram256", "equalize"):
            _add("image.histogram", fn, ax, lambda rs, s=shape: (
                [pixels(rs, "u8", s)], {}))
        for fn in ("otsu_value", "threshold_otsu", "threshold_adaptive"):
            _add("image.threshold", fn, ax, lambda rs, s=shape: (
                [pixels(rs, "u8", s)], {}))
        _add("image.threshold", "threshold_wolf", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s)], {"block_size": 5}))
        for fn in ("erode", "dilate", "close_"):
            _add("image.morph", fn, ax, lambda rs, s=shape: (
                [pixels(rs, "u8", s)], {"se": np.ones((3, 3), bool)}))
        _add("image.scale", "scale_bilinear", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s), 5, 4], {}))
        _add("image.scale", "rotate_fast", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s), np.array(-45.0, np.float32)], {}))
        _add("image.pyramid", "build_pyramid", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s)], {"levels": 4}))
        _add("image.integral", "integral", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s)], {}))
        _add("image.color", "rgb_to_gray", ax, lambda rs, s=shape: (
            [pixels(rs, "u8", s + (3,))], {}))
    # the reference's own errors
    _add("image.scale", "scale", "bad-interp", lambda rs: (
        [pixels(rs, "u8", (7, 9)), 5, 4], {"interpolation": "lanczos"}))
    _add("image.morph", "strel", "bad-shape", lambda rs: (["disk", 3], {}))
    for shape, size in (("cross", 3), ("rect", 5), ("cross", 7)):
        _add("image.morph", "strel", f"{shape}{size}", lambda rs, a=shape,
             b=size: ([a, b], {}))
    for h, w in ((1, 1), (7, 9), (480, 640)):
        _add("image.pyramid", "pyramid_sizes", f"{h}x{w}", lambda rs, h=h,
             w=w: ([h, w, 8, 0.83], {}))
    for lv in (1, 4, 8):
        _add("image.pyramid", "scale_factors", f"{lv}", lambda rs, lv=lv: (
            [lv, 0.83], {}))
        _add("image.pyramid", "scale_factors_sum", f"{lv}", lambda rs, lv=lv:
             ([lv, 0.83], {}))


def _features_cases():
    F = "features"
    for dt in ("u8", "i16", "u16", "i32", "f32", "f64"):
        _add(f"{F}.fast", "fast_strengths", dt, lambda rs, dt=dt: (
            [scene(rs, 17, 23, dt)], {}))
        _add(f"{F}.edges", "sobel_gradients", dt, lambda rs, dt=dt: (
            [scene(rs, 17, 23, dt)], {}), atol=1e-3)
        _add(f"{F}.edges", "edge_detect", dt, lambda rs, dt=dt: (
            [scene(rs, 17, 23, dt)], {"operator": "scharr"}), atol=1e-3)
        _add(f"{F}.edges", "gradient_magnitude_direction", dt,
             lambda rs, dt=dt: ([values(rs, dt, (7, 9), -99, 99),
                                 values(rs, dt, (7, 9), -99, 99)],
                                {"l2": True}), atol=1e-3)
        _add(f"{F}.hog", "gradient_fast", dt, lambda rs, dt=dt: (
            [scene(rs, 17, 23, dt)], {}), atol=1e-3)
        _add(f"{F}.canny", "canny", dt, lambda rs, dt=dt: (
            [scene(rs, 17, 23, dt)], {}))
        _add(f"{F}.ccl", "label_components", dt, lambda rs, dt=dt: (
            [(scene(rs, 17, 23) < 100).astype(DTYPES[dt])], {}))
        _add(f"{F}.ccl", "ccl_features", dt, lambda rs, dt=dt: (
            [(scene(rs, 17, 23) < 100).astype(DTYPES[dt])],
            {"config": cfg(f"{F}.ccl", "CclConfig", max_components=8)}))
    for shape in ((1, 1), (7, 9), (17, 23), (40, 48)):
        ax = f"{shape[0]}x{shape[1]}"
        _add(f"{F}.fast", "fast_strengths", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"threshold": 10, "n": 12}))
        _add(f"{F}.fast", "fast_nms", ax, lambda rs, s=shape: (
            [values(rs, "u8", s, 0, 4)], {}))
        _add(f"{F}.fast", "fast_detect", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"config": cfg(
                f"{F}.fast", "FastConfig", threshold=10, max_features=16)}))
        _add(f"{F}.canny", "canny", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {}))
        _add(f"{F}.ccl", "label_components", ax, lambda rs, s=shape: (
            [scene(rs, *s) < 100], {"connectivity": 4}))
        _add(f"{F}.ccl", "label_components_seeded", ax, lambda rs, s=shape: (
            _seeded(rs, s), {}))
        _add(f"{F}.hog", "hog_descriptor", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"config": cfg(f"{F}.hog", "HogConfig",
                                            cell_size=4)}), atol=1e-4)
        _add(f"{F}.hough", "hough_sht", ax, lambda rs, s=shape: (
            [scene(rs, *s) < 60], {"config": cfg(
                f"{F}.hough", "HoughShtConfig", threshold=4, max_lines=8,
                max_edge_points=1024)}))
        _add(f"{F}.hough", "hough_sht_stats", ax, lambda rs, s=shape: (
            [scene(rs, *s) < 60], {"config": cfg(
                f"{F}.hough", "HoughShtConfig", threshold=4, max_lines=8,
                max_edge_points=1024)}))
        _add(f"{F}.hough", "hough_kht", ax, lambda rs, s=shape: (
            [scene(rs, *s) < 60, values(rs, "f32", s, -99, 99),
             values(rs, "f32", s, -99, 99)],
            {"config": cfg(f"{F}.hough", "HoughKhtConfig", max_lines=8,
                           min_votes=2.0, max_edge_points=256)}))
        _add(f"{F}.mser", "mser_detect", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"config": cfg(
                f"{F}.mser", "MserConfig", max_regions=8,
                max_candidates=64, level_step=25)}))
        _add(f"{F}.mser", "mser_detect", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {}), tag="default")
        _add(f"{F}.mser", "mser_region_mask", ax, lambda rs, s=shape: (
            [scene(rs, *s), 0, 0, 128], {}))
        _add(f"{F}.mser", "mser_region_points", ax, lambda rs, s=shape: (
            [scene(rs, *s) < 100], {"max_points": 64}))
        _add(f"{F}.orb", "orb_detect_describe", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"config": cfg(
                f"{F}.orb", "OrbConfig", max_features=16, levels=2,
                threshold=10)}), rtol=1e-4, atol=1e-2)
        _add("slam.frontend", "detect_describe", ax, lambda rs, s=shape: (
            [scene(rs, *s)], {"config": _frontend()}), rtol=1e-4,
            atol=1e-2)
    # k = h * w: the reference's approx_max_k orders ties its own way
    # (BY_DESIGN); below that, both put the lower index first
    for ax, k in (("k=n", 40 * 48), ("k=n-1", 40 * 48 - 1), ("k<n", 20)):
        _add(f"{F}.fast", "fast_detect", ax, lambda rs, k=k: (
            [scene(rs, 40, 48)], {"config": cfg(
                f"{F}.fast", "FastConfig", threshold=10, max_features=k)}),
            seed=1)
    for bits, patch, seed in ((256, 31, 3087), (128, 15, 1)):
        _add(f"{F}.orb", "brief_pattern", f"{bits}", lambda rs, a=bits,
             b=patch, c=seed: ([a, b, c], {}))
    for dt in ("u8", "f32"):
        _add(f"{F}.orb", "patch_orientation", dt, lambda rs, dt=dt: (
            [scene(rs, 40, 48, dt)] + _kp_xy(rs, 40, 48), {}), atol=1e-3)
        _add(f"{F}.orb", "brief_describe", dt, lambda rs, dt=dt: (
            [scene(rs, 40, 48, dt)] + _kp_xy(rs, 40, 48, angle=True), {}))
    _add(f"{F}.hough", "hough_lines_to_cartesian", "8", lambda rs: (
        [tup("core.types", "Lines",
             rho=values(rs, "f32", (8,), -20, 20),
             theta=values(rs, "f32", (8,), 0, 3.1),
             strength=values(rs, "f32", (8,), 0, 9),
             valid=rs.random(8) < 0.7), 23, 17], {}))

    # a bright text page, whose background at the high levels is one
    # maze-like component: K2b's CPU twin took more than its default 64
    # pointer rounds there and raised, where the card's union-find has no
    # cap (seed 0 is such a page)
    _add(f"{F}.mser", "mser_detect", "64x96", lambda rs: (
        [text_page(rs, 64, 96)], {"config": cfg(f"{F}.mser", "MserConfig",
                                                dark=False)}),
         seed=0, tag="bright_text")

    # matchers
    M = "matchers.bruteforce"
    for nq, nt in ((5, 7), (1, 1), (0, 4), (3, 0), (1, 2)):
        ax = f"{nq}x{nt}"
        _add(M, "hamming_distance_matrix", ax, lambda rs, a=nq, b=nt: (
            [desc(rs, a), desc(rs, b)], {}))
        _add(M, "knn_match", ax, lambda rs, a=nq, b=nt: (
            [desc(rs, a), desc(rs, b), rs.random(a) < 0.8,
             rs.random(b) < 0.8], {"k": 2}))
        _add(M, "match_bruteforce", ax, lambda rs, a=nq, b=nt: (
            [desc(rs, a), desc(rs, b)], {}))
        _add(M, "match_bruteforce", ax, lambda rs, a=nq, b=nt: (
            [desc(rs, a), desc(rs, b), cfg(M, "MatcherConfig", knn=1,
                                           cross_check=True)], {}),
             tag="cross")
    _add(M, "knn_match", "k3>2", lambda rs: (
        [desc(rs, 4), desc(rs, 2)], {"k": 3}))
    _add(M, "ratio_test", "5", lambda rs: (
        [tup("core.types", "Matches",
             train_idx=values(rs, "i32", (2, 5), 0, 6),
             distance=np.sort(values(rs, "f32", (2, 5), 0, 99).round(), 0),
             valid=rs.random((2, 5)) < 0.8)], {"ratio": 0.8}))
    _add(M, "ratio_test", "k1", lambda rs: (
        [tup("core.types", "Matches",
             train_idx=values(rs, "i32", (1, 5), 0, 6),
             distance=values(rs, "f32", (1, 5), 0, 99).round(),
             valid=rs.random((1, 5)) < 0.8)], {}))

    for shape in ((1, 1), (17, 23), (40, 48)):
        _add("slam.frontend", "match_pair", f"{shape[0]}x{shape[1]}",
             lambda rs, s=shape: ([scene(rs, *s), np.roll(scene(rs, *s), 2,
                                                         1)],
                                  {"config": _frontend()}),
             rtol=1e-3, atol=1e-2)


def _geometry_cases():
    C = "calib"
    for n in (0, 3, 4, 12, 40):
        ax = f"n{n}"
        _add(f"{C}.homography", "find_homography", ax, lambda rs, n=n: (
            _correspondences(rs, n), {"config": cfg(
                f"{C}.homography", "HomographyConfig", num_hypotheses=16)}),
            rtol=1e-3, atol=1e-3)
        if n >= 4:      # fewer than 4 leave H undetermined
            _add(f"{C}.homography", "compute_homography_dlt", ax,
                 lambda rs, n=n: (_correspondences(rs, n), {}), rtol=1e-3,
                 atol=1e-3)
    for dt in ("f32", "f64", "i32"):
        _add(f"{C}.homography", "compute_homography_dlt", dt,
             lambda rs, dt=dt: (_correspondences(rs, 12, dt), {}),
             rtol=1e-3, atol=2e-3, ref_inputs=_oracle(dt))
        _add(f"{C}.homography", "symmetric_transfer_error", dt,
             lambda rs, dt=dt: ([_homography(rs, dt)]
                                + _correspondences(rs, 12, dt), {}),
             rtol=1e-4, atol=1e-3)
        _add(f"{C}.epipolar", "compute_fundamental_8pt", dt,
             lambda rs, dt=dt: (_two_view(rs, 12, dt), {}),
             rtol=1e-3, atol=1e-3, post=_unit_sign, ref_inputs=_oracle(dt))
        _add(f"{C}.epipolar", "sampson_error", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3, 3), -1, 1)] + _correspondences(rs, 9, dt,
                                                               scale=1),
            {}), rtol=1e-4, atol=1e-4)
        _add(f"{C}.epipolar", "triangulate_points", dt, lambda rs, dt=dt: (
            [np.eye(3, dtype=DTYPES[dt]),
             np.array([1, 0, 0], DTYPES[dt])]
            + _correspondences(rs, 9, dt, scale=1), {}), rtol=1e-3,
            atol=1e-3)
        _add(f"{C}.checkerboard", "line_intersections", dt,
             lambda rs, dt=dt: ([values(rs, dt, (5,), 1, 40),
                                 values(rs, "f32", (5,), 0, 1.5),
                                 values(rs, dt, (5,), 1, 40),
                                 values(rs, "f32", (5,), 1.6, 3)], {}),
             rtol=1e-4, atol=1e-3)
        _add(f"{C}.utils", "distort_normalized", dt, lambda rs, dt=dt: (
            [values(rs, dt, (6,), -1, 1), values(rs, dt, (6,), -1, 1),
             np.array([0.1, -0.05, 0.001, 0.002, 0.01], DTYPES[dt])], {}))
        _add(f"{C}.utils", "reproj_error_rms", dt, lambda rs, dt=dt: (
            [values(rs, dt, (9, 2), 0, 40), values(rs, dt, (9, 2), 0, 40),
             _mask(rs, 9)], {}))
        _add(f"{C}.utils", "undistort_points", dt, lambda rs, dt=dt: (
            [values(rs, dt, (9, 2), 0, 40), _k(dt), _dist(dt)], {}),
            rtol=1e-4, atol=1e-3)
        _add(f"{C}.utils", "project_points_dist", dt, lambda rs, dt=dt: (
            [values(rs, dt, (9, 3), 1, 5) + np.array([0, 0, 4], DTYPES[dt]),
             _k(dt), _dist(dt), values(rs, dt, (3,), -0.2, 0.2),
             values(rs, dt, (3,), -1, 1)], {}), rtol=1e-4, atol=1e-3)
        _add(f"{C}.utils", "build_undistort_map", dt, lambda rs, dt=dt: (
            [_k(dt), _dist(dt), 7, 9], {}), rtol=1e-4, atol=1e-3)
        _add(f"{C}.camera", "intrinsics_from_homographies", dt,
             lambda rs, dt=dt: ([np.stack([_view_h(rs, dt) for _ in
                                           range(3)])], {}), rtol=1e-3,
             atol=1e-2, ref_inputs=_oracle(dt))
        _add(f"{C}.camera", "extrinsics_from_homography", dt,
             lambda rs, dt=dt: ([_view_h(rs, dt), _k(dt)], {}),
             rtol=1e-3, atol=1e-3)
        # the 12 x 12 DLT system's float32 SVD, in LAPACK's and XLA's
        # orders: 5e-3 on t of norm ~5
        _add(f"{C}.pnp", "pnp_dlt", dt, lambda rs, dt=dt: (
            _pnp_points(rs, 12, dt, norm=True), {}), rtol=1e-3, atol=5e-3)
        _add(f"{C}.pnp", "solve_pnp", dt, lambda rs, dt=dt: (
            _pnp_points(rs, 12, dt) + [_k(dt)], {"config": cfg(
                f"{C}.pnp", "PnpConfig", num_hypotheses=16)}), rtol=1e-3,
            atol=1e-3)
        _add(f"{C}.epipolar", "find_essential", dt, lambda rs, dt=dt: (
            _two_view(rs, 20, dt) + [_k(dt)], {"config": cfg(
                f"{C}.epipolar", "EssentialConfig", num_hypotheses=16)}),
            rtol=1e-3, atol=1e-3, post=_unit_sign)
        _add(f"{C}.epipolar", "decompose_essential", dt, lambda rs, dt=dt: (
            _essential(rs, 20, dt), {}), rtol=1e-3, atol=1e-3)
        _add(f"{C}.utils", "undistort_image", dt, lambda rs, dt=dt: (
            [scene(rs, 7, 9, dt if dt != "i32" else "u8"), _k("f32"),
             _dist("f32")], {}), atol=1e-3)
    for rows, cols in ((2, 2), (6, 8)):
        _add(f"{C}.camera", "checkerboard_object_points", f"{rows}x{cols}",
             lambda rs, r=rows, c=cols: ([r, c, 0.025], {}))
    for shape in ((1, 1), (17, 23)):
        _add(f"{C}.checkerboard", "find_chessboard_corners",
             f"{shape[0]}x{shape[1]}", lambda rs, s=shape: (
                 [scene(rs, *s)], {}))

    # slam entry points that take arrays
    S = "slam"
    for dt in ("f32", "f64"):
        _add(f"{S}.ba", "rodrigues_to_matrix", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3,), -2, 2)], {}), atol=1e-5)
        _add(f"{S}.ba", "matrix_to_rodrigues", dt, lambda rs, dt=dt: (
            [_rotations(rs, 1, dt)[0]], {}), rtol=1e-4, atol=1e-4)
        _add(f"{S}.ba", "project_points", dt, lambda rs, dt=dt: (
            list(_ba(rs, dt)[:5]), {}), rtol=1e-4, atol=1e-3)
        _add(f"{S}.ba", "ba_residuals", dt, lambda rs, dt=dt: (
            [*_ba(rs, dt)[:2], _problem(rs, dt)], {}), rtol=1e-4, atol=1e-3)
        _add(f"{S}.ba", "reproj_rmse", dt, lambda rs, dt=dt: (
            [_problem(rs, dt)], {}), rtol=1e-4, atol=1e-3)
        _add(f"{S}.ba", "obs_jacobian_blocks", dt, lambda rs, dt=dt: (
            list(_ba(rs, dt)), {}), rtol=1e-4, atol=1e-3)
        # float32 CG sums in another order: 5e-3 on parameters of size ~5
        _add(f"{S}.ba", "ba_step", dt, lambda rs, dt=dt: (
            [_problem(rs, dt), np.array(0.1, np.float32),
             cfg(f"{S}.ba", "BAConfig", cg_iterations=8)], {}),
            rtol=1e-3, atol=5e-3)
        _add(f"{S}.ba", "ba_solve", dt, lambda rs, dt=dt: (
            [_problem(rs, dt), cfg(f"{S}.ba", "BAConfig", iterations=2,
                                   cg_iterations=8, damping=0.1)], {}),
            rtol=1e-3, atol=5e-3)
        _add(f"{S}.ba_schur", "ba_step_schur", dt, lambda rs, dt=dt: (
            [_problem(rs, dt), np.array(0.1, np.float32),
             cfg(f"{S}.ba_schur", "SchurConfig")], {}), rtol=1e-3,
            atol=1e-3)
        _add(f"{S}.ba_schur", "ba_solve_schur", dt, lambda rs, dt=dt: (
            [_problem(rs, dt), cfg(f"{S}.ba_schur", "SchurConfig",
                                   iterations=2, damping=0.1)], {}),
            rtol=1e-3,
            atol=1e-3)
        _add(f"{S}.evaluate", "umeyama_alignment", dt, lambda rs, dt=dt: (
            _trajectories(rs, 12, dt), {}), rtol=1e-3, atol=1e-4)
        _add(f"{S}.evaluate", "ate_rmse", dt, lambda rs, dt=dt: (
            _trajectories(rs, 12, dt), {}), rtol=1e-3, atol=1e-4)
        _add(f"{S}.evaluate", "rpe_rmse", dt, lambda rs, dt=dt: (
            _trajectories(rs, 12, dt), {"delta": 2}), rtol=1e-3, atol=1e-4)
        _add(f"{S}.posegraph", "compose", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3,), -1, 1) for _ in range(4)], {}),
            atol=1e-5)
        _add(f"{S}.posegraph", "invert", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3,), -1, 1) for _ in range(2)], {}),
            atol=1e-5)
        _add(f"{S}.posegraph", "relative_pose", dt, lambda rs, dt=dt: (
            [values(rs, dt, (3,), -1, 1) for _ in range(4)], {}),
            atol=1e-5)
        _add(f"{S}.posegraph", "graph_residuals", dt, lambda rs, dt=dt: (
            [values(rs, dt, (6, 6), -1, 1), _pose_graph(rs, 6, dt)], {}),
            rtol=1e-4, atol=1e-4)
        _add(f"{S}.posegraph", "optimize_pose_graph", dt, lambda rs, dt=dt: (
            [_pose_graph(rs, 6, dt), cfg(f"{S}.posegraph",
                                         "PoseGraphConfig", iterations=3,
                                         cg_iterations=10)], {}),
            rtol=1e-3, atol=1e-3)
        _add(f"{S}.pipeline", "decompose_homography", dt, lambda rs, dt=dt: (
            [_view_h(rs, dt), _k(dt)], {}), rtol=1e-3, atol=1e-3)
    _add(f"{S}.ba_schur", "max_obs_per_landmark", "8", lambda rs: (
        [values(rs, "i32", (30,), 0, 7), rs.random(30) < 0.8, 8], {}))
    _add(f"{S}.sfm", "render_orbit_sequence", "2x24x32", lambda rs: (
        [], {"n_frames": 2, "h": 24, "w": 32, "seed": 3}), atol=1e-3)


def scene(rs, h, w, dt="u8"):
    """A (h, w) image of dtype ``dt``: a few bright and dark rectangles on
    a gradient, with noise; values in [0, 256)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = 60 + 100 * xx / max(w, 1) + 20 * yy / max(h, 1)
    for _ in range(4):
        y0, x0 = rs.integers(0, max(h - 2, 1)), rs.integers(0, max(w - 2, 1))
        img[y0:y0 + max(h // 4, 1), x0:x0 + max(w // 4, 1)] = rs.choice(
            [10, 240])
    img = np.clip(img + rs.normal(size=(h, w)) * 3, 0, 255)
    return (img if dt in FLOATS else np.round(img)).astype(DTYPES[dt])


def text_page(rs, h, w):
    """A (h, w) u8 page of dark glyph-like strokes (20) on a bright ground
    (235): glyph rows every 13 px, cells every 28, strokes thickened a
    pixel right, a 3-tap smear and noise of sigma 3."""
    img = np.full((h, w), 235.0)
    for y in range(4, h - 9, 13):
        for x in range(4, w - 13, 28):
            g = rs.random((9, 12 + rs.integers(0, 10))) < 0.45
            g[:, 1:] |= g[:, :-1]
            img[y:y + 9, x:x + g.shape[1]][g[:, :w - x]] = 20
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return np.clip(np.round(img + rs.normal(size=(h, w)) * 3), 0,
                   255).astype(np.uint8)


def desc(rs, n):
    return rs.integers(0, 256, (n, 32)).astype(np.uint8)


def _seeded(rs, shape):
    b = scene(rs, *shape) < 100
    init = np.where(b, np.arange(b.size).reshape(shape), -1).astype(np.int32)
    return [b, init]


def _kp_xy(rs, h, w, n=12, angle=False):
    out = [values(rs, "f32", (n,), 0, w - 1), values(rs, "f32", (n,), 0,
                                                     h - 1)]
    if angle:
        out.append(values(rs, "f32", (n,), 0, 359))
    return out + [rs.random(n) < 0.8]


def _frontend():
    return cfg("slam.frontend", "FrontendConfig",
               orb=cfg("features.orb", "OrbConfig", max_features=32,
                       levels=2, threshold=10),
               homography=cfg("calib.homography", "HomographyConfig",
                              num_hypotheses=16))


def _correspondences(rs, n, dt="f32", scale=40):
    src = rs.uniform(0, scale, (n, 2))
    h = np.array([[1.02, 0.05, 2.0], [-0.03, 0.98, 1.0], [1e-3, 5e-4, 1.0]])
    d = np.c_[src, np.ones(n)] @ h.T
    dst = d[:, :2] / d[:, 2:]
    if dt in INTS:
        src, dst = np.round(src), np.round(dst)
    return [src.astype(DTYPES[dt]), dst.astype(DTYPES[dt])]


def _k(dt):
    return np.array([[40, 0, 4.5], [0, 42, 3.5], [0, 0, 1]], DTYPES[dt])


def _dist(dt):
    return np.array([0.05, -0.01, 0.001, 0.0005, 0.0], DTYPES[dt])


def _rotations(rs, n, dt):
    out = []
    for _ in range(n):
        q, r = np.linalg.qr(rs.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        out.append(q * np.linalg.det(q))
    return np.stack(out).astype(DTYPES[dt])


def _view_h(rs, dt):
    """The homography of a planar target seen by ``_k`` from a pose tilted
    20-40 degrees about an axis in the image plane."""
    a = rs.uniform(0, 2 * np.pi)
    axis = np.array([np.cos(a), np.sin(a), 0.0])
    th = np.deg2rad(rs.uniform(20, 40))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
    t = np.array([0.1, -0.2, 3.0])
    h = _k("f64") @ np.c_[r[:, :2], t]
    return (h / h[2, 2]).astype(DTYPES[dt])


def _pnp_points(rs, n, dt, norm=False):
    p3 = rs.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    r = _rotations(rs, 1, "f64")[0]
    r = np.eye(3) + 0.05 * (r - np.eye(3))
    u, _, vt = np.linalg.svd(r)
    pc = p3 @ (u @ vt).T + [0.1, 0.0, 0.2]
    xn = pc[:, :2] / pc[:, 2:]
    p2 = xn if norm else xn @ _k("f64")[:2, :2].T + _k("f64")[:2, 2]
    return [p3.astype(DTYPES[dt]), p2.astype(DTYPES[dt])]


def _two_view(rs, n, dt):
    p3 = rs.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    k = _k("f64")

    def proj(p):
        x = p[:, :2] / p[:, 2:]
        return x @ k[:2, :2].T + k[:2, 2]
    return [proj(p3).astype(DTYPES[dt]),
            proj(p3 + [0.5, 0.0, 0.1]).astype(DTYPES[dt])]


def _essential(rs, n, dt):
    p3 = rs.uniform(-1, 1, (n, 3)) + [0, 0, 5]
    t = np.array([0.5, 0.0, 0.1])
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    src = p3[:, :2] / p3[:, 2:]
    q = p3 + t
    dst = q[:, :2] / q[:, 2:]
    return [tx.astype(DTYPES[dt]), src.astype(DTYPES[dt]),
            dst.astype(DTYPES[dt]), np.ones(n, bool)]


def _ba(rs, dt, f=3, n_lm=10):
    """A small BA problem: every landmark seen by every camera, the
    observations the true projections plus 0.3 px of noise, cameras and
    landmarks then perturbed."""
    cams = np.c_[rs.normal(size=(f, 3)) * 0.05, rs.normal(size=(f, 3)) * 0.2]
    lms = rs.uniform(-1, 1, (n_lm, 3)) + [0, 0, 5]
    intr = np.array([40.0, 42.0, 16.0, 12.0])
    o = f * n_lm
    ci = np.repeat(np.arange(f), n_lm).astype(np.int32)
    li = np.tile(np.arange(n_lm), f).astype(np.int32)
    uv = _project(cams[ci], lms[li], intr) + rs.normal(size=(o, 2)) * 0.3
    cams = cams + rs.normal(size=cams.shape) * 0.01
    lms = lms + rs.normal(size=lms.shape) * 0.02
    valid = np.ones(o, bool)
    valid[rs.choice(o, 2, replace=False)] = False
    return (cams.astype(DTYPES[dt]), lms.astype(DTYPES[dt]),
            intr.astype(DTYPES[dt]), ci, li, uv.astype(DTYPES[dt]), valid)


def _project(cams, pts, intr):
    out = []
    for c, x in zip(cams, pts):
        th = np.linalg.norm(c[:3])
        k = c[:3] / max(th, 1e-12)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        r = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        p = r @ x + c[3:]
        out.append([intr[0] * p[0] / p[2] + intr[2],
                    intr[1] * p[1] / p[2] + intr[3]])
    return np.array(out)


def _problem(rs, dt):
    names = ("cameras", "landmarks", "intrinsics", "cam_idx", "lm_idx", "uv",
             "valid")
    return tup("slam.ba", "BAProblem", **dict(zip(names, _ba(rs, dt))))


def _trajectories(rs, n, dt):
    gt = np.cumsum(rs.normal(size=(n, 3)), 0)
    est = 1.3 * gt @ _rotations(rs, 1, "f64")[0].T + 0.5 + rs.normal(
        size=(n, 3)) * 0.01
    return [est.astype(DTYPES[dt]), gt.astype(DTYPES[dt])]


def _pose_graph(rs, n, dt):
    e = n + 2
    i = np.r_[np.arange(n - 1), 0, 1, 2][:e].astype(np.int32)
    j = np.r_[np.arange(1, n), n - 1, 3, 4][:e].astype(np.int32)
    return tup("slam.posegraph", "PoseGraph",
               poses=values(rs, dt, (n, 6), -0.3, 0.3),
               edge_i=i, edge_j=j,
               edge_meas=values(rs, dt, (e, 6), -0.3, 0.3),
               edge_weight=np.ones(e, DTYPES[dt]),
               edge_valid=rs.random(e) < 0.9)


def _unit_sign(tree):
    """A matrix defined up to scale and sign, scaled to unit norm with a
    positive dot product with a fixed vector (the largest entry would not
    do: a skew-symmetric F has two of equal size)."""
    if not isinstance(tree, np.ndarray):
        return tree
    v = tree.astype(np.float64)
    v = v / max(np.linalg.norm(v), 1e-30)
    u = np.sqrt(np.arange(1.0, v.size + 1)).reshape(v.shape)
    return (v * (1.0 if np.sum(v * u) >= 0 else -1.0)).astype(tree.dtype)


def _as_float32(args, kwargs):
    """The inputs with every integer array as float32."""
    def conv(v):
        if isinstance(v, np.ndarray) and v.dtype.kind in "iu":
            return v.astype(np.float32)
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    return conv(args), {k: conv(v) for k, v in kwargs.items()}


def _oracle(dt):
    """``ref_inputs`` of an integer axis of a function in
    REFERENCE_FAULTS: the reference run on float32 inputs."""
    return _as_float32 if dt in INTS else None


def _symmetric(a):
    return ((a + a.T) // 2 if np.issubdtype(a.dtype, np.integer)
            else (a + a.T) / 2).astype(a.dtype)


def _line_points(rs, dt):
    x = rs.integers(0, 20, 6)
    return np.stack([x, 2 * x + 1], 1).astype(DTYPES[dt])


def _mask(rs, n):
    m = rs.random(n) < 0.7
    m[0] = True
    return m


def _homography(rs, dt):
    h = np.eye(3) + rs.normal(size=(3, 3)) * [[0.1, 0.1, 3], [0.1, 0.1, 3],
                                               [1e-3, 1e-3, 0]]
    return h.astype(DTYPES[dt])


def _noisy_line(rs, dt, n=24):
    x = rs.uniform(0, 50, n)
    y = 0.5 * x + 3 + rs.normal(size=n) * 0.3
    y[:4] += 20
    return np.stack([x, y], 1).round().astype(DTYPES[dt]) if dt in INTS \
        else np.stack([x, y], 1).astype(DTYPES[dt])


def _noisy_parabola(rs, dt, n=24):
    x = rs.uniform(-10, 10, n)
    y = 0.2 * x * x - x + 4 + rs.normal(size=n) * 0.2
    y[:3] += 15
    pts = np.stack([x + 10, y], 1)
    return pts.round().astype(DTYPES[dt]) if dt in INTS else \
        pts.astype(DTYPES[dt])


def _pca_model(rs):
    q, _ = np.linalg.qr(rs.normal(size=(5, 3)))
    return tup("math.pca", "PcaModel",
               mean=rs.normal(size=(5,)).astype(np.float32),
               vectors=q.T.astype(np.float32),
               values=np.array([3.0, 2.0, 1.0], np.float32))


def _line_sign(tree):
    """A LineFit's (a, b, c) up to sign (the TLS normal's sign is the
    eigen-solver's)."""
    name, fields = tree
    fields = dict(fields)
    fields["abc"] = _unit_sign(fields["abc"]) * np.linalg.norm(
        fields["abc"].astype(np.float64)).astype(fields["abc"].dtype)
    return (name, fields)


def _pca_post(tree):
    """PcaModel's vectors up to sign (columns)."""
    name, fields = tree
    fields = dict(fields)
    fields["vectors"] = sign_fix((0, 1))([fields["vectors"]])[0]
    return (name, fields)


GROUPS = {"math": _math_cases, "ops": _ops_cases, "image": _image_cases,
          "features": _features_cases, "geometry": _geometry_cases}


def cases(group: str) -> list[Case]:
    """The cases of one group ("math", "ops", "image", "geometry"); each
    case's seed is its place in its group."""
    _SINK.clear()
    GROUPS[group]()
    out = list(_SINK)
    _SINK.clear()
    return out


# -------------------------------------------------------------- outcomes

def builtin_class(exc: BaseException) -> str:
    """The nearest built-in class of an exception (JAX's and PyTorch's own
    classes derive from them)."""
    import builtins
    for cls in type(exc).__mro__:
        if getattr(builtins, cls.__name__, None) is cls:
            return cls.__name__
    return type(exc).__name__


def to_tree(x):
    """A result as a numpy tree: arrays (torch, JAX, numpy) as numpy
    arrays, NamedTuples as (name, {field: tree}), dicts, lists (tuples
    too), Python scalars and None as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__,
                {k: to_tree(v) for k, v in zip(x._fields, x)})
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: to_tree(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [to_tree(v) for v in x]
    if isinstance(x, dict):
        return {k: to_tree(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (np.ndarray, np.generic)) or hasattr(x, "__array__"):
        return np.asarray(x)
    return repr(x)


def outcome(fn, args, kwargs):
    """("ok", numpy tree) or ("raise", built-in class name, message)."""
    try:
        return ("ok", to_tree(fn(*args, **kwargs)))
    except Exception as exc:  # noqa: BLE001 - the class is the outcome
        return ("raise", builtin_class(exc), str(exc)[:300])


def _cmp(want, got, rtol, atol, path, out):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        if not (isinstance(want, np.ndarray) and isinstance(got, np.ndarray)):
            out.append(f"{path}: {type(want).__name__} vs "
                       f"{type(got).__name__}")
            return
        if want.dtype != got.dtype or want.shape != got.shape:
            out.append(f"{path}: {want.dtype}{want.shape} vs "
                       f"{got.dtype}{got.shape}")
            return
        if want.dtype.kind in "biu":
            if not np.array_equal(want, got):
                bad = int(np.sum(want != got))
                out.append(f"{path}: {bad} of {want.size} differ")
        elif want.dtype.kind == "f":
            w, g = want.astype(np.float64), got.astype(np.float64)
            ok = np.isclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
            if not ok.all():
                err = np.nanmax(np.abs(np.where(ok, 0, g - w)))
                out.append(f"{path}: {int((~ok).sum())} of {w.size} beyond "
                           f"rtol {rtol} atol {atol} (max {err:.3g})")
        elif not np.array_equal(want, got):
            out.append(f"{path}: differ")
        return
    if type(want) is not type(got):
        out.append(f"{path}: {type(want).__name__} vs {type(got).__name__}")
        return
    if isinstance(want, tuple):             # (NamedTuple name, fields)
        if want[0] != got[0]:
            out.append(f"{path}: {want[0]} vs {got[0]}")
            return
        _cmp(want[1], got[1], rtol, atol, f"{path}.{want[0]}", out)
    elif isinstance(want, list):
        if len(want) != len(got):
            out.append(f"{path}: {len(want)} vs {len(got)} items")
            return
        for i, (a, b) in enumerate(zip(want, got)):
            _cmp(a, b, rtol, atol, f"{path}[{i}]", out)
    elif isinstance(want, dict):
        if set(want) != set(got):
            out.append(f"{path}: keys {sorted(want)} vs {sorted(got)}")
            return
        for k in want:
            _cmp(want[k], got[k], rtol, atol, f"{path}.{k}", out)
    elif isinstance(want, float):
        if not np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True):
            out.append(f"{path}: {want} vs {got}")
    elif want != got:
        out.append(f"{path}: {want!r} vs {got!r}")


def compare(want, got, case: Case) -> list[str]:
    """The differences between two outcomes of ``case`` (empty: agree)."""
    if want[0] != got[0]:
        return [f"{want[0]} {want[1] if want[0] == 'raise' else ''} vs "
                f"{got[0]} {got[1] if got[0] == 'raise' else ''}: "
                f"{(got if got[0] == 'raise' else want)[2]}"]
    if want[0] == "raise":
        return [] if want[1] == got[1] else [
            f"raise {want[1]} vs {got[1]}: {got[2]}"]
    a, b = want[1], got[1]
    if case.post is not None:
        a, b = case.post(a), case.post(b)
    out: list[str] = []
    _cmp(a, b, case.rtol, case.atol, "", out)
    return out


# ------------------------------------------------------------ the port

_TORCH_DTYPES = {"u8": torch.uint8, "i8": torch.int8, "u16": torch.uint16,
                 "i16": torch.int16, "u32": torch.uint32, "i32": torch.int32,
                 "f32": torch.float32, "f64": torch.float64}


def run_port(case: Case, device="cpu", package: str = "compv_tpu_torch"):
    """The port's outcome of ``case``, its inputs on ``device`` (passed as
    ``device=`` too where the function takes it)."""
    def resolve(module, name):
        return getattr(importlib.import_module(f"{package}.{module}"), name)

    fn = resolve(case.module, case.fn)
    args, kwargs = case.inputs()

    def array(a):
        # a C-ordered copy (np.ascontiguousarray would make a 0-d array 1-d)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    args = convert(args, array, resolve, _TORCH_DTYPES.__getitem__)
    kwargs = convert(kwargs, array, resolve, _TORCH_DTYPES.__getitem__)
    if "device" in inspect.signature(fn).parameters:
        kwargs.setdefault("device", device)
    return outcome(fn, args, kwargs)


# ----------------------------------------------- what is not swept, and why

# case id -> why the port differs from the reference there on purpose; the
# parity files check that each still differs
BY_DESIGN: dict = {
    **{f"features.fast.fast_strengths[{dt}]":
       "FAST runs on uint8 images only: K1 and its twin take the kernel's "
       "byte image, and the port raises ValueError for another dtype, where "
       "the reference computes its twin in int32 of any image"
       for dt in ("i16", "u16", "i32", "f32", "f64")},
    "features.hog.hog_descriptor[1x1]":
        "an image with fewer cells than a block needs: the port raises "
        "ValueError naming the sizes, where the reference fails inside "
        "(TypeError from a reshape, ZeroDivisionError) or returns a block "
        "count of -1 as 0",
    "features.fast.fast_detect[k=n]":
        "at max_features = h * w the reference's approx_max_k on the CPU "
        "orders tied strengths neither by ascending nor descending index; "
        "the port's stable sort puts the lower index first, as both do "
        "below that (the keypoint sets are equal: "
        "test_torch_parity_features.py::test_fast_detect_ties_at_k_equal_n)",
}

# (module, function) -> the fault of the reference that the port does not
# copy; its integer cases are held to the reference on float32 inputs
# (``_oracle``), and the parity files check that the fault still shows
REFERENCE_FAULTS: dict = {
    ("math.stats", "hartley_normalize"):
        "builds T in the points' integer dtype, so its scale and offsets "
        "are truncated (s -> 0; compv_tpu/math/stats.py:38-40)",
    ("calib.epipolar", "compute_fundamental_8pt"):
        "normalizes integer points through hartley_normalize's truncated "
        "T, so F is built from points scaled by 0",
    ("calib.homography", "compute_homography_dlt"):
        "normalizes integer points through hartley_normalize's truncated "
        "T: H is NaN or built from points scaled by 0",
    ("calib.camera", "intrinsics_from_homographies"):
        "returns K in the homographies' integer dtype, its focal lengths "
        "and principal point truncated",
}

# case id -> a difference between the port on the card and on the CPU
# that is known and not repaired, with its reason; phase 24 of
# chip_smoke.py checks that each still differs there
CARD_FAULTS: dict = {
    "calib.pnp.pnp_dlt[f32]":
        "the reference's float32 DLT: the smallest eigenvector of a 12 x 12 "
        "normal matrix whose two smallest eigenvalues are 0 and 5.6e-6 of "
        "its largest (12 points within 1 of each other at depth 5); the "
        "card's eigh returns t 0.28 from LAPACK's, where the reference "
        "and the CPU port agree within 2e-3. An eigh in float64 agrees but "
        "moves the 128-frame SfM run out of sfm_128.json's bars (RPE "
        "0.068 against 0.0174), so the port keeps float32",
}

# (module, function) -> why no case calls it
NOT_SWEPT: dict = {
    ("math.pca", "pca_save_json"):
        "takes a file path; test_torch_math_more.py holds both packages' "
        "files loaded by the other",
    ("math.pca", "pca_load_json"):
        "takes a file path; test_torch_math_more.py holds both packages' "
        "files loaded by the other",
    ("calib.lm", "levenberg_marquardt"):
        "takes a residual function written against its own package's "
        "arrays; test_torch_calib.py holds it on the same residuals",
    ("calib.ransac", "ransac"):
        "takes model and residual functions written against its own "
        "package's arrays; test_torch_fit.py holds it on the same ones",
    ("calib.camera", "calibrate_camera"):
        "a pipeline (Zhang + LM) over many views; test_torch_calib.py "
        "holds it against the reference at focal 250, 800 and 2500",
    ("slam.ba", "ba_step_reduce_scatter"):
        "needs a process group (its axis); test_torch_parallel.py holds "
        "it at 2 and 4 ranks",
    ("slam.pipeline", "track_planar_sequence"):
        "a pipeline over a frame sequence; test_torch_pipeline.py holds it "
        "against the reference, the re-localization branch included",
    ("slam.sfm", "run_sfm"):
        "a pipeline over a frame sequence; test_torch_sfm.py holds it "
        "against the reference and the goldens",
}
# a public class of a swept module is a config or a result type, not swept
# by value: test_torch_surface.py holds its name, the interop tests its
# fields
NOT_SWEPT_CLASSES = ("a config dataclass or a result NamedTuple: its name "
                     "is held by test_torch_surface.py, its fields by the "
                     "interop conversions of each module's tests")


def reference_callables(root: str) -> dict:
    """{(module, name): "function" or "class"} of every public callable
    (a name of ``__all__`` defined by ``def`` or ``class``) of the swept
    reference modules under ``root`` (the repository), read from their
    sources: no JAX is imported."""
    import ast
    import os
    out = {}
    for pkg in SWEPT_PACKAGES:
        base = os.path.join(root, "compv_tpu", pkg)
        for name in sorted(os.listdir(base)):
            if not name.endswith(".py") or name == "__init__.py":
                continue
            tree = ast.parse(open(os.path.join(base, name)).read())
            defs = {n.name: "class" if isinstance(n, ast.ClassDef)
                    else "function" for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
            public = []
            for n in tree.body:
                if isinstance(n, ast.Assign) and any(
                        getattr(t, "id", "") == "__all__" for t in n.targets):
                    public = [e.value for e in n.value.elts]
            for fn in public:
                if fn in defs:
                    out[(f"{pkg}.{name[:-3]}", fn)] = defs[fn]
    return out


# ------------------------------------------------------------ own tests

def test_every_generator_is_deterministic_from_its_seed():
    for group in GROUPS:
        for case in cases(group):
            _same_spec(case.inputs(), case.inputs(), case.id)


def _same_spec(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b, equal_nan=True), where
    elif isinstance(a, (list, tuple)) and not isinstance(a, (Cfg, Tup)):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _same_spec(x, y, where)
    elif isinstance(a, (Cfg, Tup)):
        assert a.module == b.module and a.name == b.name, where
        _same_spec(a.fields, b.fields, where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_spec(a[k], b[k], where)
    else:
        assert a == b, where


def test_case_ids_are_unique():
    ids = [c.id for g in GROUPS for c in cases(g)]
    assert len(ids) == len(set(ids)), [i for i in ids if ids.count(i) > 1]
    assert len(ids) > 1000


def test_tables_name_cases_that_exist():
    all_cases = [c for g in GROUPS for c in cases(g)]
    ids = {c.id for c in all_cases}
    swept = {(c.module, c.fn) for c in all_cases}
    for cid, why in BY_DESIGN.items():
        assert cid in ids and why, cid
    for key, why in REFERENCE_FAULTS.items():
        held = [c for c in all_cases
                if (c.module, c.fn) == key and c.ref_inputs is not None]
        assert held and why, key
    assert all(c.ref_inputs is None for c in all_cases
               if (c.module, c.fn) not in REFERENCE_FAULTS)
    for key, why in NOT_SWEPT.items():
        assert key not in swept and why, key
    for cid, why in CARD_FAULTS.items():
        assert cid in ids and why, cid


def test_every_public_callable_is_swept_or_says_why():
    """The coverage case: each public function of the swept reference
    modules has a case or a NOT_SWEPT reason; each public class is a config
    or a result type (NOT_SWEPT_CLASSES)."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    public = reference_callables(root)
    assert len(public) > 200
    swept = {(c.module, c.fn) for g in GROUPS for c in cases(g)}
    missing = [key for key, kind in public.items()
               if kind == "function" and key not in swept
               and key not in NOT_SWEPT]
    assert not missing, f"neither swept nor in NOT_SWEPT: {missing}"
    stale = [key for key in NOT_SWEPT if key not in public]
    assert not stale, f"NOT_SWEPT names no public function: {stale}"


def test_outcomes_compare_by_class_dtype_shape_and_tolerance():
    case = Case("m", "f", "x", 0, lambda rs: ([], {}))
    f = np.array([1.0, 2.0], np.float32)
    assert compare(("ok", f), ("ok", f + 1e-5), case) == []
    assert compare(("ok", f), ("ok", f + 1e-2), case)
    assert compare(("ok", f), ("ok", f.astype(np.float64)), case)
    assert compare(("ok", np.arange(3)), ("ok", np.arange(3)[::-1]), case)
    assert compare(("ok", to_tree([f])), ("ok", to_tree((f,))), case) == []
    assert compare(("raise", "ValueError", ""),
                   ("raise", "ValueError", "other words"), case) == []
    assert compare(("raise", "ValueError", ""), ("raise", "TypeError", ""),
                   case)
    assert compare(("raise", "ValueError", ""), ("ok", f), case)
    assert builtin_class(NotImplementedError()) == "NotImplementedError"

    class Own(ValueError):
        pass
    assert builtin_class(Own()) == "ValueError"
