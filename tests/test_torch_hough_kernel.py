"""Port parity for the SHT accumulator (K4): the reference's f32 trig
tables, ``batched_weighted_bincount``, and the kernel's twin (what a CPU
tensor runs) against ``compv_tpu``'s XLA twin (``_rho_bins`` +
``batched_weighted_bincount``, jitted as ``hough_sht`` runs it off the TPU)
and against the Pallas kernel ``sht_accumulate_pallas`` run in interpret
mode.

Every comparison is exact: the accumulators are integer vote counts, and
with the reference's trig table, its fused multiply-add and its reciprocal
the f32 rho bins are bit-equal. The kernel itself is held against the twin
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Interpret mode: the module fixture replaces ``pl.pallas_call`` with
``functools.partial(pl.pallas_call, interpret=True)`` before the Pallas
wrapper is first traced, so the TPU kernel body runs on the CPU; nothing in
``compv_tpu`` changes.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu.ops import bincount as jbincount
from compv_tpu_torch.features import hough_trig
from compv_tpu_torch.ops import bincount
from compv_tpu_torch.ops.kernels import _build, hough_kernel

jhough = importlib.import_module("compv_tpu.features.hough")
jpallas = importlib.import_module("compv_tpu.ops.pallas.hough_kernel")


@pytest.fixture(scope="module")
def interpret_pallas():
    """``sht_accumulate_pallas`` with its ``pallas_call`` in interpret
    mode, for this module's tests."""
    pl = jpallas.pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield jpallas.sht_accumulate_pallas


def _edges(seed: int, n: int, h: int, w: int, valid_frac: float = 0.7):
    rs = np.random.default_rng(seed)
    x = rs.integers(0, w, n).astype(np.float32)
    y = rs.integers(0, h, n).astype(np.float32)
    wt = (rs.random(n) < valid_frac).astype(np.int32)
    return x, y, wt


def _dense_map():
    """The dense 480x640 map of tests/test_edges.py:147-155."""
    rs = np.random.default_rng(3)
    img = np.zeros((480, 640), np.uint8)
    img[rs.uniform(size=img.shape) < 0.12] = 255
    img[40, :] = 255
    img[:, 200] = 255
    return img


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jitted_xla_twin(x, y, wt, step_deg, rho_max, rho_step):
    theta_step = float(np.deg2rad(step_deg))
    n_theta = int(np.round(np.pi / theta_step))
    rbin, n_rho = jhough._rho_bins(x, y, n_theta, rho_max, rho_step,
                                   theta_step)
    w = jnp.broadcast_to(wt[None, :], rbin.shape)
    return jbincount.batched_weighted_bincount(rbin, w, n_rho)


def _jax_twin(x, y, wt, step_deg, rho_max, rho_step):
    """The XLA twin jitted, as ``hough_sht`` runs it (``_accumulate`` inside
    ``_hough_sht_impl``'s jit)."""
    return np.asarray(_jitted_xla_twin(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(wt), step_deg, rho_max,
                                       rho_step))


def _port_twin(x, y, wt, step_deg, rho_max, rho_step):
    cos_t, sin_t = hough_trig.theta_table(step_deg)
    return hough_kernel.sht_accumulate(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(wt),
        hough_trig.theta_count(step_deg), rho_max, rho_step, cos_t,
        sin_t).numpy()


# ---------------------------------------------------------------- trig

@pytest.mark.parametrize("step", [1.0, 0.5])
def test_stored_trig_tables_are_xlas(step):
    theta_step = float(np.deg2rad(step))
    n = int(np.round(np.pi / theta_step))
    thetas = jnp.arange(n, dtype=jnp.float32) * theta_step
    cos_t, sin_t = hough_trig.theta_table(step)
    for got, want in ((cos_t, jnp.cos(thetas)), (sin_t, jnp.sin(thetas))):
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("step", [2.0, 0.25, 1.5])
def test_other_steps_take_the_float64_table(step):
    th = hough_trig._thetas(step)
    cos_t, sin_t = hough_trig.theta_table(step)
    assert cos_t.shape == (hough_trig.theta_count(step),)
    np.testing.assert_array_equal(
        cos_t.numpy(), np.cos(th.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(
        sin_t.numpy(), np.sin(th.astype(np.float64)).astype(np.float32))


def test_thetas_equal_the_references():
    for step in (1.0, 0.5, 0.25):
        want = jnp.arange(hough_trig.theta_count(step), dtype=jnp.float32) \
            * float(np.deg2rad(step))
        np.testing.assert_array_equal(hough_trig._thetas(step),
                                      np.asarray(want))


# ---------------------------------------------------------------- bincount

@pytest.mark.parametrize("seed,a,e,n_bins", [(0, 1, 10, 5), (1, 7, 300, 200),
                                             (2, 180, 1000, 1601)])
def test_batched_weighted_bincount_matches_reference(seed, a, e, n_bins):
    rs = np.random.default_rng(seed)
    bins = rs.integers(0, n_bins, (a, e)).astype(np.int32)
    w = rs.integers(0, 4, (a, e)).astype(np.int32)
    want = np.asarray(jbincount.batched_weighted_bincount(
        jnp.asarray(bins), jnp.asarray(w), n_bins))
    got = bincount.batched_weighted_bincount(torch.from_numpy(bins),
                                             torch.from_numpy(w), n_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- K4 twin

@pytest.mark.parametrize("step", [1.0, 0.5])
@pytest.mark.parametrize("rho_step", [1.0, 0.7])
@pytest.mark.parametrize("seed,n,h,w", [(0, 500, 60, 80), (1, 4000, 240, 320),
                                        (2, 3, 5, 7)])
def test_twin_equals_xla_twin(step, rho_step, seed, n, h, w):
    x, y, wt = _edges(seed, n, h, w)
    rho_max = float(np.hypot(h, w))
    want = _jax_twin(x, y, wt, step, rho_max, rho_step)
    got = _port_twin(x, y, wt, step, rho_max, rho_step)
    assert got.shape == (hough_trig.theta_count(step),
                         hough_kernel.n_rho_bins(rho_max, rho_step))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step", [1.0, 0.5])
def test_twin_empty_edge_list(step):
    x = np.zeros(0, np.float32)
    wt = np.zeros(0, np.int32)
    got = _port_twin(x, x, wt, step, 50.0, 1.0)
    np.testing.assert_array_equal(got, _jax_twin(x, x, wt, step, 50.0, 1.0))
    assert got.sum() == 0


def test_twin_dense_map_equals_xla_twin():
    img = _dense_map()
    h, w = img.shape
    ys, xs = np.nonzero(img)
    x = np.zeros(65536, np.float32)
    y = np.zeros(65536, np.float32)
    wt = np.zeros(65536, np.int32)
    x[:xs.size], y[:ys.size], wt[:xs.size] = xs, ys, 1
    rho_max = float(np.hypot(h, w))
    got = _port_twin(x, y, wt, 1.0, rho_max, 1.0)
    np.testing.assert_array_equal(got, _jax_twin(x, y, wt, 1.0, rho_max, 1.0))
    assert got.sum() == 180 * xs.size   # every edge votes once per theta


@pytest.mark.parametrize("step,rho_step,seed,n,h,w", [
    (1.0, 1.0, 0, 500, 60, 80), (0.5, 0.7, 1, 500, 60, 80),
    (1.0, 1.3, 2, 500, 60, 80), (1.0, 1.0, 3, 30000, 720, 1282),
    (1.0, 0.7, 4, 30000, 720, 1282)])
def test_twin_equals_pallas_interpret(interpret_pallas, step, rho_step, seed,
                                      n, h, w):
    x, y, wt = _edges(seed, n, h, w)
    rho_max = float(np.hypot(h, w))
    n_theta = hough_trig.theta_count(step)
    want = np.asarray(interpret_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(wt), n_theta, rho_max,
        rho_step, float(np.deg2rad(step)), w, h))
    np.testing.assert_array_equal(_port_twin(x, y, wt, step, rho_max,
                                             rho_step), want)


@pytest.mark.parametrize("rho_step", [1.0, 0.7])
def test_fused_rounding_is_what_the_reference_computes(rho_step):
    """At 720p scale the fused multiply-add and the reciprocal move votes:
    the same edges binned with separate roundings and an IEEE division give
    another accumulator, and the jitted reference agrees with the fused
    one."""
    h, w = 720, 1282
    x, y, wt = _edges(6, 30000, h, w)
    rho_max = float(np.hypot(h, w))
    got = _port_twin(x, y, wt, 1.0, rho_max, rho_step)
    np.testing.assert_array_equal(got, _jax_twin(x, y, wt, 1.0, rho_max,
                                                 rho_step))
    cos_t, sin_t = (t.numpy() for t in hough_trig.theta_table(1.0))
    rho = cos_t[:, None] * x[None, :] + sin_t[:, None] * y[None, :]
    rbin = np.clip(np.round((rho + np.float32(rho_max)) / np.float32(rho_step)
                            ).astype(np.int64), 0, got.shape[1] - 1)
    unfused = np.stack([np.bincount(r, weights=wt, minlength=got.shape[1])
                        for r in rbin]).astype(np.int64)
    assert (unfused != got).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_f32_is_correctly_rounded(seed):
    """``fma_f32`` against an exact rational evaluation, including halfway
    cases built on purpose (a product that puts the sum on an f32
    midpoint)."""
    from fractions import Fraction
    rs = np.random.default_rng(seed)
    a = rs.normal(size=400).astype(np.float32)
    b = (rs.normal(size=400) * 1e3).astype(np.float32)
    c = (rs.normal(size=400) * 1e3).astype(np.float32)
    c[:100] = np.float32(2048.0)           # ulp 2^-11 at 2048
    a[:100] = np.float32(2.0 ** -12)       # a*b = b * 2^-12: on midpoints
    b[:100] = rs.integers(-8, 8, 100).astype(np.float32) + np.float32(0.5)
    a[100:150] = np.float32(-4.371139e-08)  # cos(90 deg) of the table
    got = hough_kernel.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(c)).numpy()
    for i in range(400):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ok = [v for v, e in zip(cands, errs) if e == best]
        if len(ok) > 1:   # tie: even mantissa
            ok = [v for v in ok if int(np.float32(v).view(np.uint32)) % 2 == 0]
        assert got[i] == ok[0], (i, a[i], b[i], c[i])


def test_cpu_tensors_run_the_twin():
    x, y, wt = _edges(5, 100, 30, 40)
    before = _build.launch_counts()
    _port_twin(x, y, wt, 1.0, 50.0, 1.0)
    assert _build.launch_counts() == before


def test_wrapper_rejects_bad_inputs():
    cos_t, sin_t = hough_trig.theta_table(1.0)
    x = torch.zeros(4)
    w = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError):   # float weights
        hough_kernel.sht_accumulate(x, x, w.float(), 180, 5.0, 1.0, cos_t,
                                    sin_t)
    with pytest.raises(ValueError):   # table of the wrong length
        hough_kernel.sht_accumulate(x, x, w, 90, 5.0, 1.0, cos_t, sin_t)
    with pytest.raises(ValueError):   # ragged edge list
        hough_kernel.sht_accumulate(x, x[:3], w, 180, 5.0, 1.0, cos_t,
                                    sin_t)


# ---------------------------------------------------------------------------
# A numpy model of the Hopper kernel's split (csrc/hough_kernel.cu): the
# edge list dealt in groups of 128 slots to the S CTAs of a cluster, T
# thetas a CTA, bins rounded by the magic-number add, S partial histograms
# summed slice by slice, every element of the accumulator written once.
# With ``shift`` the accumulator is rho-tiled as the kernel tiles a row that
# is wider than a block's shared memory: a CTA holds 2^shift bins of its
# thetas, a vote lands at its bin modulo the tile width and adds its weight
# only in the bin's own tile.

_GROUP = 128


def _magic_bins(x, y, cos_t, sin_t, rho_max, rho_step):
    """(n_theta, E) int32 bins by the kernel's f32 sequence."""
    rho = hough_kernel.fma_f32(cos_t[:, None], x[None, :],
                               sin_t[:, None] * y[None, :]).numpy()
    v = (rho + np.float32(rho_max)) * (np.float32(1) / np.float32(rho_step))
    assert v.dtype == np.float32
    top = np.float32(hough_kernel.n_rho_bins(rho_max, rho_step) - 1)
    clamped = np.minimum(np.maximum(v, np.float32(0)), top)
    magic = np.float32(12582912.0)
    return (clamped + magic).view(np.int32) - magic.view(np.int32)


def _split_model(x, y, wt, n_theta, rho_max, rho_step, cos_t, sin_t, t, s,
                 shift=None):
    n_rho = hough_kernel.n_rho_bins(rho_max, rho_step)
    e = x.numel()
    bins_all = _magic_bins(x, y, cos_t, sin_t, rho_max, rho_step)
    w = wt.numpy().astype(np.int64)
    group_of = np.arange(e) // _GROUP
    acc = np.full((n_theta, n_rho), -12345, np.int64)
    written = np.zeros((n_theta, n_rho), np.int64)
    pitch = n_rho if shift is None else 1 << shift
    for tile in range(-(-n_rho // pitch)):
        r0 = tile * pitch
        for t0 in range(0, n_theta, t):
            nt = min(t, n_theta - t0)
            bins = nt * pitch
            partial = np.zeros((s, bins), np.int64)
            for rank in range(s):
                mine = np.flatnonzero(group_of % s == rank)
                for k in range(nt):
                    b = bins_all[t0 + k, mine]
                    np.add.at(partial[rank], k * pitch + b % pitch,
                              np.where(b // pitch == tile, w[mine], 0))
            per = (-(-bins // s) + 3) & ~3
            for rank in range(s):
                b0 = min(bins, rank * per)
                b1 = min(bins, b0 + per)
                for b in range(b0, b1, 4 if shift is not None else 1):
                    width = 4 if shift is not None else 1
                    col = r0 + b % pitch
                    keep = max(0, min(width, n_rho - col))
                    acc[t0 + b // pitch, col:col + keep] = \
                        partial[:, b:b + keep].sum(0)
                    written[t0 + b // pitch, col:col + keep] += 1
    assert (written == 1).all()
    return acc


def _split_case(name):
    rs = np.random.default_rng(31)
    h, w = 60, 80
    n = {"E_0": 0, "E_1": 1, "E_127": 127, "E_129": 129, "E_1000": 1000,
         "E_4097": 4097}.get(name, 3000)
    x = rs.integers(0, w, n).astype(np.float32)
    y = rs.integers(0, h, n).astype(np.float32)
    wt = np.zeros(n, np.int32)
    wt[:int(0.4 * n)] = 1                           # a prefix, as hough_sht
    if name == "scattered_heavy":                   # scattered, weights > 1
        wt = (rs.random(n) < 0.4) * rs.integers(1, 5, n)
    cos_t, sin_t = hough_trig.theta_table(1.0)
    n_theta = 180
    if name == "theta_1":
        n_theta, cos_t, sin_t = 1, cos_t[:1], sin_t[:1]
    if name == "theta_181":
        n_theta = 181
        cos_t, sin_t = torch.cat([cos_t, cos_t[:1]]), torch.cat([sin_t,
                                                                 sin_t[:1]])
    return (torch.from_numpy(x), torch.from_numpy(y),
            torch.from_numpy(wt.astype(np.int32)), n_theta,
            float(np.hypot(h, w)), 0.7 if name == "rho_0.7" else 1.0,
            cos_t.contiguous(), sin_t.contiguous())


@pytest.mark.parametrize("t,s", [(6, 4), (8, 8), (1, 8), (11, 4), (5, 3),
                                 (16, 1)])
@pytest.mark.parametrize("name", ["prefix", "E_0", "E_1", "E_127", "E_129",
                                  "E_1000", "E_4097", "scattered_heavy",
                                  "theta_1", "theta_181", "rho_0.7"])
def test_split_model_equals_twin(name, t, s):
    args = _split_case(name)
    want = hough_kernel.sht_accumulate_ref(*args).numpy()
    got = _split_model(*args, t, s)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == args[3] * int(args[2].sum())


def test_magic_rounding_is_rint_then_clip():
    """Clamping in f32 and adding 1.5 * 2^23 gives round-half-even then
    clip, also on ties, below 0, above the top bin and at NaN."""
    v = np.array([-3.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, 3.4999998, 199.5,
                  200.0, 200.5, 1e9, -1e9, np.inf, -np.inf, np.nan,
                  4194303.5], np.float32)
    for top in (200, 4194303):
        clamped = np.fmin(np.fmax(v, np.float32(0)), np.float32(top))
        magic = np.float32(12582912.0)
        got = (clamped + magic).view(np.int32) - magic.view(np.int32)
        want = np.clip(np.rint(np.nan_to_num(v.astype(np.float64), nan=0.0)),
                       0, top).astype(np.int64)
        np.testing.assert_array_equal(got, want)


def _wide_case(n_theta=3):
    """A list whose accumulator row is wider than the 58,112 bins a block's
    shared memory holds (227 KB): a 60 x 80 map at a rho step of 0.003."""
    rs = np.random.default_rng(37)
    n = 700
    x = rs.integers(0, 80, n).astype(np.float32)
    y = rs.integers(0, 60, n).astype(np.float32)
    wt = ((rs.random(n) < 0.6) * rs.integers(1, 4, n)).astype(np.int32)
    cos_t, sin_t = hough_trig.theta_table(1.0)
    pick = torch.linspace(0, 179, n_theta).long()
    return (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(wt),
            n_theta, 100.0, 0.003, cos_t[pick].contiguous(),
            sin_t[pick].contiguous())


@pytest.mark.parametrize("t,s,shift", [(1, 1, 15), (1, 4, 15), (2, 2, 14),
                                       (1, 8, 13)])
def test_rho_tiled_split_model_equals_twin_past_shared_memory(t, s, shift):
    args = _wide_case()
    want = hough_kernel.sht_accumulate_ref(*args).numpy()
    assert want.shape[1] == 66668 > 58112
    got = _split_model(*args, t, s, shift)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == args[3] * int(args[2].sum())


@pytest.mark.parametrize("shift", [2, 5, 7])
@pytest.mark.parametrize("name", ["prefix", "E_1", "E_129", "scattered_heavy",
                                  "theta_181", "rho_0.7"])
def test_rho_tiled_split_model_equals_twin(name, shift):
    """The same tiling at widths that leave a ragged last tile, rows that
    start off 16 bytes and tiles narrower than a slice."""
    args = _split_case(name)
    want = hough_kernel.sht_accumulate_ref(*args).numpy()
    got = _split_model(*args, 5, 3, shift)
    np.testing.assert_array_equal(got, want)


def test_wide_twin_equals_xla_twin_and_pallas_interpret(interpret_pallas):
    """At an n_rho past the old kernel's limit the twin still equals the
    jitted reference and the Pallas kernel."""
    rs = np.random.default_rng(41)
    h, w, rho_step = 60, 80, 0.003
    x, y, wt = _edges(41, 400, h, w)
    rho_max = float(np.hypot(h, w))
    got = _port_twin(x, y, wt, 1.0, rho_max, rho_step)
    assert got.shape[1] == 66668
    np.testing.assert_array_equal(got, _jax_twin(x, y, wt, 1.0, rho_max,
                                                 rho_step))
    want = np.asarray(interpret_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(wt), 180, rho_max,
        rho_step, float(np.deg2rad(1.0)), w, h))
    np.testing.assert_array_equal(got, want)
