"""Port parity for the text-blob path's labeling and features: histogram,
Otsu, the CCL labeler's twin (what a CPU tensor runs for K2a / K2b), run
extraction, the compactor's twin (K3), ``ccl_features`` and
``ccl_features_from_labels``, against ``compv_tpu`` on the same numpy
inputs (its XLA branches: on the CPU the JAX package runs the sweep and
pointer solver and the padded run sort, never its Pallas kernels).

Tolerances: everything integer is exact, labels and ``num_components``
always. ``CclResult`` rows are compared as sorted sets of rows, because
the reference orders equal-area rows by an unstable sort; where the
capacity does not cover every component, the rows above the C-th area
are compared as a set and the count of rows at that area exactly.
Centroids within 1e-6 relative: both render exact integer moments in f32.
The kernels themselves are held against these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from compv_tpu.core import golden as jgolden
from compv_tpu.features import ccl as jccl
from compv_tpu.image import histogram as jhist
from compv_tpu.image import threshold as jthr
from compv_tpu_torch.core import golden
from compv_tpu_torch.features import ccl
from compv_tpu_torch.image import histogram, threshold
from compv_tpu_torch.interop import (config_from_reference, result_from_numpy,
                                     result_to_numpy)
from compv_tpu_torch.ops.kernels import ccl_kernel, compact_kernel
from tests.fixtures import make_test_image

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(_ROOT, "goldens", "goldens.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def blob_img():
    img = np.zeros((64, 96), np.uint8)
    img[5:15, 5:20] = 255
    img[30:50, 40:60] = 255
    img[60:63, 90:95] = 255
    img[20, 70] = 255
    return img


def _snake(h=40, w=40):
    """The boustrophedon snake of tests/test_ccl_mser_hog.py."""
    img = np.zeros((h, w), np.uint8)
    for r in range(0, h, 4):
        img[r, :] = 255
        if r + 4 < h:
            img[r:r + 4, w - 1 if (r // 4) % 2 == 0 else 0] = 255
    return img


def _random_bin(seed, density, shape=(64, 80)):
    return (np.random.default_rng(seed).random(shape) < density
            ).astype(np.uint8)


def _oracle_labels(img, connectivity):
    """Min-flat-index labels from scipy's partition (independent of both)."""
    structure = np.ones((3, 3)) if connectivity == 8 else None
    lab, n = ndimage.label(img > 0, structure=structure)
    out = np.full(img.shape, -1, np.int64)
    if n:
        flat = np.arange(img.size).reshape(img.shape)
        mins = np.asarray(ndimage.minimum(flat, lab, np.arange(1, n + 1)))
        out[lab > 0] = mins.astype(np.int64)[lab[lab > 0] - 1]
    return out


# ------------------------------------------------------- histogram / Otsu

@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (3, 40, 61)])
def test_histogram256_exact(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = histogram.histogram256(torch.from_numpy(img))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jhist.histogram256(
                                      jnp.asarray(img))))


def test_otsu_value_golden_and_reference(goldens):
    gray = make_test_image()
    got = threshold.otsu_value(torch.from_numpy(gray))
    assert got.dtype == torch.int32
    assert int(got) == goldens["otsu_value"] == int(
        jthr.otsu_value(jnp.asarray(gray)))


@pytest.mark.parametrize("seed", range(6))
def test_otsu_value_exact(seed):
    rs = np.random.default_rng(seed)
    shape = tuple(rs.integers(40, 400, 2))
    img = np.clip(rs.normal(rs.uniform(60, 190), rs.uniform(10, 70), shape)
                  + 60 * (rs.random(shape) < 0.3), 0, 255).astype(np.uint8)
    assert int(threshold.otsu_value(torch.from_numpy(img))) == int(
        jthr.otsu_value(jnp.asarray(img)))


@pytest.mark.parametrize("inverse", [False, True])
def test_threshold_otsu_and_global_exact(inverse):
    gray = make_test_image()
    b, t = threshold.threshold_otsu(torch.from_numpy(gray))
    jb, jt = jthr.threshold_otsu(jnp.asarray(gray))
    assert int(t) == int(jt)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    got = threshold.threshold_global(torch.from_numpy(gray), 100, 200, inverse)
    want = jthr.threshold_global(jnp.asarray(gray), 100, 200, inverse)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- labeling (twin)

def _edge_shapes():
    rs = np.random.default_rng(5)
    return [np.zeros((9, 13), np.uint8), np.full((9, 13), 255, np.uint8),
            np.full((1, 1), 255, np.uint8), np.zeros((1, 1), np.uint8),
            (rs.random((1, 57)) < 0.5).astype(np.uint8) * 255,
            (rs.random((57, 1)) < 0.5).astype(np.uint8) * 255]


@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_components_exact_on_shapes(blob_img, connectivity):
    for img in [blob_img, _snake(), _snake(24, 70)] + _edge_shapes():
        got = ccl.label_components(torch.from_numpy(img), connectivity)
        want = np.asarray(jccl.label_components(jnp.asarray(img),
                                                connectivity))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      _oracle_labels(img, connectivity))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("density", [0.3, 0.5, 0.6])
@pytest.mark.parametrize("seed", [0, 1])
def test_label_components_exact_on_random(seed, density, connectivity):
    img = _random_bin(seed, density)
    got = ccl.label_components(torch.from_numpy(img), connectivity).numpy()
    want = np.asarray(jccl.label_components(jnp.asarray(img), connectivity))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_labels(img, connectivity))


def test_reference_nonconvergence_raises():
    """Near the 4-connected percolation threshold the reference's pointer
    stage can stop at its 64-round cap with labels that are not the fixed
    point, and returns them (ROADMAP Queue 3). The twin raises at that cap
    instead, and is right with more rounds."""
    rs = np.random.default_rng(3)
    rs.random((64, 80))
    rs.random((64, 80))
    img = (rs.random((64, 80)) < 0.6).astype(np.uint8)
    oracle = _oracle_labels(img, 4)
    want = np.asarray(jccl.label_components(jnp.asarray(img), 4))
    assert not np.array_equal(want, oracle)
    with pytest.raises(RuntimeError, match="did not converge"):
        ccl.label_components(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(
        ccl.label_components(torch.from_numpy(img), 4, 256).numpy(), oracle)


def _ladder_gray(img_kind):
    if img_kind == "scene":
        return make_test_image()[:90, :120]
    if img_kind == "snake":
        return np.where(_snake(40, 52) > 0, 10, 200).astype(np.uint8)
    # uniform gray: the levels sweep the density through both percolation
    # thresholds (0.59 4-connected, 0.41 8-connected)
    return np.random.default_rng(4).integers(0, 256, (64, 80), dtype=np.uint8)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("img_kind", ["random", "snake", "scene"])
def test_label_components_seeded_exact(connectivity, img_kind):
    """A nested ladder: each level seeded by the previous level's labels
    (own flat index at new pixels), as MSER runs it."""
    gray = _ladder_gray(img_kind)
    idx = np.arange(gray.size, dtype=np.int32).reshape(gray.shape)
    prev = np.full(gray.shape, -1, np.int32)
    for t in range(15, 256, 30):
        fg = (gray <= t).astype(np.uint8)
        init = np.where(prev >= 0, prev, idx).astype(np.int32)
        want = np.asarray(jccl.label_components_seeded(
            jnp.asarray(fg), jnp.asarray(init), connectivity))
        got = ccl.label_components_seeded(torch.from_numpy(fg),
                                          torch.from_numpy(init),
                                          connectivity)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      _oracle_labels(fg, connectivity))
        prev = want


def _nested_ladder(gray, connectivity, levels=range(15, 256, 30)):
    """(fg, init) per level, each seeded by the level before (oracle labels;
    own flat index at new pixels), as MSER builds them."""
    idx = np.arange(gray.size, dtype=np.int32).reshape(gray.shape)
    prev = np.full(gray.shape, -1, np.int32)
    for t in levels:
        fg = (gray <= t).astype(np.uint8)
        yield fg, np.where(prev >= 0, prev, idx).astype(np.int32)
        prev = _oracle_labels(fg, connectivity).astype(np.int32)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("img_kind", ["random", "snake", "scene"])
def test_seeded_equals_unseeded_on_nested_ladders(connectivity, img_kind):
    """What licenses a warm start: under the seed's precondition the seeded
    labeling is the unseeded one, in the reference and in the port. (Rounds
    enough for both pointer stages near percolation.)"""
    for fg, init in _nested_ladder(_ladder_gray(img_kind), connectivity):
        oracle = _oracle_labels(fg, connectivity)
        jseed = jccl.label_components_seeded(jnp.asarray(fg),
                                             jnp.asarray(init), connectivity,
                                             1000)
        jplain = jccl.label_components(jnp.asarray(fg), connectivity, 1000)
        np.testing.assert_array_equal(np.asarray(jseed), np.asarray(jplain))
        np.testing.assert_array_equal(np.asarray(jseed), oracle)
        seeded = ccl.label_components_seeded(torch.from_numpy(fg),
                                             torch.from_numpy(init),
                                             connectivity, 1000)
        plain = ccl.label_components(torch.from_numpy(fg), connectivity, 1000)
        assert torch.equal(seeded, plain)
        np.testing.assert_array_equal(seeded.numpy(), oracle)
        # the precondition itself: a depth-one forest toward smaller indices
        on = fg.reshape(-1) > 0
        flat = init.reshape(-1)
        idx = np.arange(fg.size)
        assert (flat[on] <= idx[on]).all() and on[flat[on]].all()
        np.testing.assert_array_equal(flat[flat[on]], flat[on])


def _warm_union_find_model(fg, init, connectivity, rng):
    """The seeded kernel's algorithm, run sequentially: the sanitising seed
    pass with its run starts, exactly the unions its merge rules make (each with the parent
    compare first) in a shuffled order, and the read-only flatten. Returns
    the labels and the number of unions that got past the compare."""
    h, w = fg.shape
    on = fg.reshape(-1) > 0
    n = h * w
    idx = np.arange(n)
    s = init.reshape(-1).astype(np.int64)
    bad = (s < 0) | (s > idx)
    bad |= ~on[np.where(bad, 0, s)]
    parent = np.where(on, np.where(bad, idx, s), -1)
    # own-seed pixels point at the first of their run of such pixels inside
    # the 32-pixel row segment
    fresh = (parent == idx).reshape(h, w)
    for y in range(h):
        for x0 in range(0, w, 32):
            start = None
            for x in range(x0, min(x0 + 32, w)):
                start = (x if start is None else start) if fresh[y, x] else None
                if start is not None:
                    parent[y * w + x] = y * w + start

    m = fg > 0
    pad = np.pad(m, 1)
    west, north = pad[1:-1, :-2], pad[:-2, 1:-1]
    nw, ne = pad[:-2, :-2], pad[:-2, 2:]
    flat = idx.reshape(h, w)
    edges = [(flat[m & west], flat[m & west] - 1)]
    if connectivity == 4:
        take = m & north & ~(west & nw)
        edges.append((flat[take], flat[take] - w))
    else:
        take = m & west & ~north & ne
        edges.append((flat[take], flat[take] - w + 1))
        take = m & ~west & north
        edges.append((flat[take], flat[take] - w))
        take = m & ~west & ~north & nw
        edges.append((flat[take], flat[take] - w - 1))
        take = m & ~west & ~north & ne
        edges.append((flat[take], flat[take] - w + 1))
    a = np.concatenate([e[0] for e in edges])
    b = np.concatenate([e[1] for e in edges])
    order = rng.permutation(a.size)

    def find(x):                       # path splitting, as find_root
        p = parent[x]
        while p != x:
            gp = parent[p]
            if gp != p:
                parent[x] = gp
            x, p = p, gp
        return x

    real = 0
    for i, j in zip(a[order].tolist(), b[order].tolist()):
        if parent[i] == parent[j]:
            continue
        real += 1
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    out = parent.copy()
    for i in np.flatnonzero(on).tolist():
        x = i
        while parent[x] != x:          # read only
            x = parent[x]
        out[i] = x
    return out.reshape(h, w), real


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("img_kind", ["random", "snake", "scene"])
def test_warm_union_find_model_equals_twin_and_scipy(connectivity, img_kind):
    """The seeded kernel's rule set, where no kernel can run: a sequential
    model of it equals the twin and scipy on every level of the ladders,
    from the ladder's seed and from a cold one; a level that changes
    nothing leaves no union past the parent compare."""
    rng = np.random.default_rng(17)
    for fg, init in _nested_ladder(_ladder_gray(img_kind), connectivity):
        got, _ = _warm_union_find_model(fg, init, connectivity, rng)
        want = ccl_kernel.label_ref(torch.from_numpy(fg > 0),
                                    torch.from_numpy(init), connectivity,
                                    1000)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got, _oracle_labels(fg, connectivity))
        # own-index seed (a cold start) gives the same labels
        cold = np.arange(fg.size, dtype=np.int32).reshape(fg.shape)
        got_cold, _ = _warm_union_find_model(fg, cold, connectivity, rng)
        np.testing.assert_array_equal(got_cold, got)
        same = np.where(got >= 0, got, cold).astype(np.int32)
        got_same, real = _warm_union_find_model(fg, same, connectivity, rng)
        np.testing.assert_array_equal(got_same, got)
        assert real == 0


@pytest.mark.parametrize("connectivity", [4, 8])
def test_warm_union_find_model_sanitises_bad_seeds(connectivity):
    """Seeds below 0, above the pixel's own index or on background are
    replaced by the own index, so the labels stay those of the mask."""
    rng = np.random.default_rng(23)
    fg = _random_bin(8, 0.5)
    n = fg.size
    good = _oracle_labels(fg, connectivity).astype(np.int32)
    init = np.where(good >= 0, good, 0).astype(np.int32).reshape(-1)
    on = np.flatnonzero(fg.reshape(-1))
    off = np.flatnonzero(fg.reshape(-1) == 0)
    hit = rng.choice(on, 400, replace=False)
    init[hit[:100]] = -7
    init[hit[100:200]] = n + 5
    init[hit[200:300]] = np.minimum(hit[200:300] + 1 + rng.integers(0, 50, 100),
                                    n - 1)
    init[hit[300:]] = off[np.searchsorted(off, hit[300:]) - 1]  # bg below p
    init[off] = rng.integers(-2 ** 31, 2 ** 31 - 1, off.size)   # ignored
    got, _ = _warm_union_find_model(fg, init.reshape(fg.shape), connectivity,
                                    rng)
    np.testing.assert_array_equal(got, good)


# A numpy model of the unseeded kernel's decomposition (csrc/ccl_kernel.cu,
# K2a): tiles labelled completely on tile-local parent arrays (runs named by
# the tile-local index of their first pixel, the unions of the row rules in
# any order), the seam pixels' unions on the global map, the read-only
# flatten. The kernel's tile is 32 x 32; the model takes any.

def _find(parent, x):
    """Root of x with path splitting, as find_root / find_local."""
    p = parent[x]
    while p != x:
        gp = parent[p]
        if gp != p:
            parent[x] = gp
        x, p = p, gp
    return x


def _unite(parent, a, b):
    ra, rb = _find(parent, a), _find(parent, b)
    if ra != rb:
        parent[max(ra, rb)] = min(ra, rb)


def _row_rule_edges(m, west, north, nw, ne, connectivity):
    """(pixel, offset) pairs of the row rules on the masks given: the
    unions of a pixel with the row above that the runs do not imply."""
    if connectivity == 4:
        return [(m & north & ~(west & nw), (-1, 0))]
    return [(m & west & ~north & ne, (-1, 1)),
            (m & ~west & north, (-1, 0)),
            (m & ~west & ~north & nw, (-1, -1)),
            (m & ~west & ~north & ne, (-1, 1))]


def _tiled_union_find_model(fg, connectivity, th, tw, rng):
    """Returns (labels, the global map after the tile pass, seam unions)."""
    h, w = fg.shape
    on = fg > 0
    out = np.full(h * w, -1, np.int64)
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            t = np.zeros((th, tw), bool)         # the tile, 0 past the image
            sub = on[ty0:ty0 + th, tx0:tx0 + tw]
            t[:sub.shape[0], :sub.shape[1]] = sub
            par = np.full(th * tw, -1, np.int64)
            for r in range(th):                  # run starts in the tile row
                start = None
                for x in range(tw):
                    start = (x if start is None else start) if t[r, x] else None
                    if start is not None:
                        par[r * tw + x] = r * tw + start
            pad = np.pad(t, 1)
            west, north = pad[1:-1, :-2], pad[:-2, 1:-1]
            nw, ne = pad[:-2, :-2], pad[:-2, 2:]
            a, b = [], []
            local = np.arange(th * tw).reshape(th, tw)
            for take, (dy, dx) in _row_rule_edges(t, west, north, nw, ne,
                                                  connectivity):
                a.append(local[take])
                b.append(local[take] + dy * tw + dx)
            a, b = np.concatenate(a), np.concatenate(b)
            for k in rng.permutation(a.size):
                _unite(par, int(a[k]), int(b[k]))
            for r in range(sub.shape[0]):
                for x in range(sub.shape[1]):
                    if t[r, x]:
                        root = r * tw + x
                        while par[root] != root:     # read only
                            root = par[root]
                        out[(ty0 + r) * w + tx0 + x] = (
                            (ty0 + root // tw) * w + tx0 + root % tw)
    after_tiles = out.copy().reshape(h, w)

    pad = np.pad(on, 1)
    west, north, east = pad[1:-1, :-2], pad[:-2, 1:-1], pad[1:-1, 2:]
    nw, ne = pad[:-2, :-2], pad[:-2, 2:]
    yy, xx = np.mgrid[0:h, 0:w]
    row0, col0, col1 = yy % th == 0, xx % tw == 0, (xx + 1) % tw == 0
    flat = np.arange(h * w).reshape(h, w)
    edges = [(take & row0, off) for take, off in _row_rule_edges(
        on, west, north, nw, ne, connectivity)]
    above = ~row0                                # north lies in the tile row
    edges.append((on & col0 & west & ~(above & north & nw), (0, -1)))
    if connectivity == 8:
        edges.append((on & col0 & above & nw & ~west & ~north, (-1, -1)))
        edges.append((on & col1 & above & ne & ~north & ~east, (-1, 1)))
    a = np.concatenate([flat[take] for take, _ in edges])
    b = np.concatenate([flat[take] + dy * w + dx for take, (dy, dx) in edges])
    for k in rng.permutation(a.size):
        _unite(out, int(a[k]), int(b[k]))
    labels = out.copy()
    for i in np.flatnonzero(on.reshape(-1)).tolist():
        x = i
        while out[x] != x:                       # read only
            x = out[x]
        labels[i] = x
    return labels.reshape(h, w), after_tiles, a.size


def _serpent(h, w, step):
    """One component that winds through the whole map: full rows every
    ``step`` rows, joined at alternating ends."""
    img = np.zeros((h, w), np.uint8)
    for k, r in enumerate(range(0, h, step)):
        img[r, :] = 1
        if r + step < h:
            img[r:r + step, w - 1 if k % 2 == 0 else 0] = 1
    return img


def _tile_cases(th, tw):
    """Masks that stress a tiling of th x tw: H or W of 1, sizes one below,
    at and above a multiple of the tile each way, a component through every
    tile, a full map, checkerboards of single pixels, random masks."""
    rs = np.random.default_rng(th * 1000 + tw)
    yy, xx = np.mgrid[0:2 * th + 1, 0:2 * tw + 3]
    cases = {"1xN": rs.random((1, 2 * tw + 5)) < 0.6,
             "Nx1": rs.random((2 * th + 5, 1)) < 0.6,
             "serpent": _serpent(3 * th + 2, 2 * tw + 1, 2),
             "serpent_3": _serpent(2 * th + 1, 3 * tw - 1, 3),
             "full": np.ones((2 * th + 1, 2 * tw + 1), bool),
             "empty": np.zeros((th + 1, tw + 1), bool),
             "checker": (yy + xx) % 2 == 0,
             "checker_odd": (yy + xx) % 2 == 1,
             "diagonals": (yy + xx) % 3 == 0,
             "antidiagonals": (yy - xx) % 3 == 0}
    for dh in (-1, 0, 1):
        for dw in (-1, 0, 1):
            cases[f"edge{dh:+d}{dw:+d}"] = rs.random(
                (2 * th + dh, 2 * tw + dw)) < 0.55
    return {k: np.asarray(v).astype(np.uint8) for k, v in cases.items()}


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("th,tw", [(32, 32), (32, 64), (16, 32), (4, 8),
                                   (3, 5)])
def test_tiled_union_find_model_equals_twin_scipy_and_reference(
        connectivity, th, tw):
    """The unseeded kernel's decomposition, where no kernel can run: tile-
    local labeling, seam unions and flatten give the twin's labels,
    scipy's partition and the reference's labels; after the tile pass every
    tree is one level deep; only seam pixels unite in the global map."""
    rng = np.random.default_rng(29)
    for name, img in _tile_cases(th, tw).items():
        if (th, tw) == (32, 64) and name.startswith("edge") \
                and name not in ("edge-1-1", "edge+0+0", "edge+1+1"):
            continue                     # the largest tile: three of the nine
        got, after, seam_unions = _tiled_union_find_model(
            img, connectivity, th, tw, rng)
        h, w = img.shape
        idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
        want = ccl_kernel.label_ref(torch.from_numpy(img > 0), idx,
                                    connectivity, 4000).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(got, _oracle_labels(img, connectivity),
                                      err_msg=name)
        on = img.reshape(-1) > 0
        flat = after.reshape(-1)
        np.testing.assert_array_equal(flat[flat[on]], flat[on], err_msg=name)
        assert (flat[on] <= np.arange(h * w)[on]).all(), name
        seam_pixels = (-(-h // th) - 1) * w + 2 * (-(-w // tw) - 1) * h
        assert seam_unions <= max(seam_pixels, 0) * 2, name
        if h * w <= 2500:                # the reference's XLA solver: small
            ref = np.asarray(jccl.label_components(jnp.asarray(img),
                                                   connectivity, 4000))
            np.testing.assert_array_equal(got, ref, err_msg=name)


from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 24), st.integers(1, 24), st.integers(0, 2 ** 32 - 1),
       st.floats(0.15, 0.85), st.sampled_from([4, 8]),
       st.sampled_from([(3, 5), (4, 8), (8, 4), (32, 32)]))
def test_tiled_union_find_model_on_random_masks(h, w, seed, density,
                                                connectivity, tile):
    """Random masks of any size and density, tiles that cut them anywhere,
    the unions in a random order: the twin's labels and scipy's partition."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) < density).astype(np.uint8)
    got, _, _ = _tiled_union_find_model(img, connectivity, *tile, rng)
    idx = torch.arange(h * w, dtype=torch.int32).reshape(h, w)
    want = ccl_kernel.label_ref(torch.from_numpy(img > 0), idx, connectivity,
                                4000).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle_labels(img, connectivity))


def test_labeler_wrapper_checks():
    img = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="connectivity"):
        ccl_kernel.ccl_label(img, 6)
    with pytest.raises(ValueError, match="init"):
        ccl_kernel.ccl_label_seeded(img, torch.zeros((5, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        ccl_kernel.ccl_label(torch.zeros((2, 4, 5), dtype=torch.uint8))
    # non-u8 input: foreground is > 0, as the reference's `binary > 0`
    f = torch.tensor([[0.5, -1.0, 2.0]])
    np.testing.assert_array_equal(ccl_kernel.ccl_label(f).numpy(),
                                  [[0, -1, 2]])


def test_twin_raises_only_without_convergence():
    """The twin returns when the last allowed round converged, and raises
    when another round would still change the labels."""
    img = torch.from_numpy(_snake(40, 40) > 0)
    idx = torch.arange(1600, dtype=torch.int32).reshape(40, 40)
    big = 1600
    lbl0 = torch.where(img, idx, big)
    rounds = 0
    lbl = lbl0
    while True:
        new = ccl_kernel._pointer_step(lbl, img, 8, big)
        rounds += 1
        if torch.equal(new, lbl):
            break
        lbl = new
    changing = rounds - 1                    # rounds that changed labels
    done = ccl_kernel._pointer_stage(lbl0, img, 8, big, changing)
    assert torch.equal(done, lbl)
    with pytest.raises(RuntimeError):
        ccl_kernel._pointer_stage(lbl0, img, 8, big, changing - 1)


# ------------------------------------------------------- runs and K3 twin

@pytest.mark.parametrize("k", [3, 16, 128])
def test_extract_runs_exact(k):
    rs = np.random.default_rng(9)
    img = (rs.random((48, 75)) < 0.45).astype(np.uint8)
    lbl = jccl.label_components(jnp.asarray(img))
    want = jccl.extract_runs(lbl, k)
    got = ccl.extract_runs(torch.from_numpy(np.array(lbl)), k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _compact_oracle(a, b, counts, cap8):
    """numpy prefix sums and a row-by-row copy (later rows overwrite)."""
    h, k = a.shape
    nch = -(-np.minimum(counts, k) // 8)
    off8 = np.cumsum(nch) - nch
    total8 = int(nch.sum())
    off8 = np.maximum(np.minimum(off8, cap8 - np.maximum(nch, 1)), 0)
    oa = np.zeros(cap8 * 8, np.int32)
    ob = np.zeros(cap8 * 8, np.int32)
    for i in range(h):
        n8 = int(nch[i]) * 8
        oa[off8[i] * 8:off8[i] * 8 + n8] = a[i, :n8]
        ob[off8[i] * 8:off8[i] * 8 + n8] = b[i, :n8]
    return oa, ob, total8 * 8, total8 <= cap8


@pytest.mark.parametrize("cap8", [400, 60, 7])
def test_compact_twin_equals_prefix_sum_oracle(cap8):
    rs = np.random.default_rng(2)
    h, k = 50, 24
    counts = rs.integers(0, 40, h).astype(np.int32)   # some beyond K
    counts[[3, 17]] = 0
    a = rs.integers(-2 ** 31, 2 ** 31, (h, k), dtype=np.int64).astype(np.int32)
    b = rs.integers(0, 10 ** 6, (h, k)).astype(np.int32)
    want = _compact_oracle(a, b, counts, cap8)
    got = compact_kernel.compact_rows(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(counts), cap8)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert int(got[2]) == want[2] and bool(got[3]) == want[3]
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool


@pytest.mark.parametrize("h,k,cap8,case,fits", [
    (1, 8, 4, "one row", True), (7, 16, 64, "below a block of rows", True),
    (9, 16, 64, "one past a block of rows", True),
    (1182, 128, 8192, "sparse", True), (9, 16, 64, "zero counts", True),
    (9, 16, 64, "counts above K", True), (40, 24, 30, "overflow", False),
    (1182, 128, 8192, "overflow", False),
    (9, 16, 2, "capacity of one row", False)])
def test_compact_twin_edge_cases(h, k, cap8, case, fits):
    """The cases the one-launch kernel must match, held on the twin against
    the row-by-row oracle: H around the kernel's 8-row blocks, empty rows,
    counts past the record width, frames that overflow."""
    rs = np.random.default_rng(h * 131 + k)
    if case == "zero counts":
        counts = np.zeros(h, np.int32)
    elif case == "counts above K":
        counts = rs.integers(k, 3 * k, h).astype(np.int32)
    else:
        top = k // 2 if case == "sparse" else k + 9
        counts = rs.integers(0, top, h).astype(np.int32)
        counts[rs.random(h) < 0.2] = 0
    a = rs.integers(-2 ** 31, 2 ** 31, (h, k), dtype=np.int64).astype(np.int32)
    b = rs.integers(0, 10 ** 6, (h, k)).astype(np.int32)
    want = _compact_oracle(a, b, counts, cap8)
    assert want[3] == fits
    got = compact_kernel.compact_ref(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(counts), cap8)
    assert int(got[2]) == want[2] and bool(got[3]) == want[3]
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_compact_rejects_capacity_below_one_row():
    t = torch.zeros((4, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="one full row"):
        compact_kernel.compact_rows(t, t, torch.zeros(4, dtype=torch.int32), 3)


def test_compact_twin_matches_reference_prefix():
    """The reference's XLA-side offsets and total (compact_kernel.py:57-69)
    give the same total and ok; slots before the total agree."""
    rs = np.random.default_rng(6)
    lbl = np.asarray(jccl.label_components(jnp.asarray(
        (rs.random((40, 64)) < 0.5).astype(np.uint8))))
    run_lbl, run_x0, run_x1, counts = ccl.extract_runs(torch.from_numpy(lbl),
                                                       16)
    oa, ob, total, ok = compact_kernel.compact_rows(run_lbl, run_x1, counts,
                                                    512)
    assert bool(ok)
    want = _compact_oracle(run_lbl.numpy(), run_x1.numpy(), counts.numpy(),
                           512)
    assert int(total) == want[2]
    np.testing.assert_array_equal(oa[:int(total)].numpy(), want[0][:want[2]])
    with pytest.raises(ValueError, match="multiple of 8"):
        compact_kernel.compact_rows(run_lbl[:, :12], run_x1[:, :12], counts, 8)


# ------------------------------------------------------- features

def _rows(res):
    v = np.asarray(res.valid if not hasattr(res.valid, "numpy")
                   else res.valid.numpy())

    def f(name):
        x = getattr(res, name)
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x)[v]

    ints = np.stack([f("area"), f("box_y0"), f("box_x0"), f("box_y1"),
                     f("box_x1")], 1).astype(np.int64)
    floats = np.stack([f("cx"), f("cy")], 1).astype(np.float64)
    order = sorted(range(len(ints)), key=lambda i: (tuple(ints[i]),
                                                    tuple(floats[i])))
    return ints[order], floats[order]


def _assert_same_result(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.num_components) == int(want.num_components)
    assert got.area.dtype == torch.int32 and got.cx.dtype == torch.float32
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    assert gv.sum() == wv.sum()
    # descending areas; padding after the valid rows
    areas = got.area.numpy()
    assert (np.diff(areas[gv]) <= 0).all() and not gv[int(gv.sum()):].any()
    c = len(gv)
    if int(want.num_components) <= c:
        gi, gf = _rows(got)
        wi, wf = _rows(want)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gf, wf, rtol=1e-6)
    else:
        # capacity cut: rows above the C-th area as a set, ties counted
        a_c = int(np.asarray(want.area)[wv].min())
        assert int(areas[gv].min()) == a_c
        gi, gf = _rows(got)
        wi, wf = _rows(want)
        np.testing.assert_array_equal(gi[gi[:, 0] > a_c], wi[wi[:, 0] > a_c])
        np.testing.assert_allclose(gf[gi[:, 0] > a_c], wf[wi[:, 0] > a_c],
                                   rtol=1e-6)
        assert (gi[:, 0] == a_c).sum() == (wi[:, 0] == a_c).sum()


def _both(img, cfg):
    got = ccl.ccl_features(torch.from_numpy(img),
                           config_from_reference(cfg))
    want = jccl.ccl_features(jnp.asarray(img), cfg)
    return got, want


def test_ccl_features_blobs(blob_img):
    got, want = _both(blob_img, jccl.CclConfig(max_components=16))
    _assert_same_result(got, want)
    assert got.area.numpy()[:4].tolist() == [400, 150, 15, 1]
    assert (int(got.box_x0[0]), int(got.box_y0[0]), int(got.box_x1[0]),
            int(got.box_y1[0])) == (40, 30, 59, 49)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_ccl_features_random_full_capacity(seed, connectivity):
    img = _random_bin(seed + 10, 0.35, (96, 120))
    got, want = _both(img, jccl.CclConfig(connectivity=connectivity,
                                          max_components=2048))
    assert int(got.num_components) <= 2048
    _assert_same_result(got, want)


@pytest.mark.parametrize("capacity", [8, 64])
def test_ccl_features_capacity_cut(capacity):
    img = _random_bin(21, 0.3, (96, 120))
    got, want = _both(img, jccl.CclConfig(max_components=capacity))
    assert int(got.num_components) > capacity
    _assert_same_result(got, want)


def test_ccl_features_run_path_without_compactor():
    """max_runs_per_row = 100 (not a multiple of 8) takes the padded run
    sort instead of the compactor, as the reference's non-TPU branch."""
    img = _random_bin(31, 0.4, (60, 90))
    cfg = jccl.CclConfig(max_components=1024, max_runs_per_row=100)
    got, want = _both(img, cfg)
    _assert_same_result(got, want)


def test_ccl_features_pixel_path_row_overflow():
    img = np.zeros((16, 300), np.uint8)
    img[:, ::2] = 1                          # 150 runs/row > capacity 128
    got, want = _both(img * 255, jccl.CclConfig(max_components=160))
    _assert_same_result(got, want)
    assert (got.area.numpy()[got.valid.numpy()] == 16).all()


def test_ccl_features_pixel_path_compactor_overflow(monkeypatch):
    """A frame of more run records than the compactor holds (600 rows x
    120 runs = 72000 > 65536) diverts to the pixel path."""
    img = np.zeros((600, 240), np.uint8)
    img[:, ::2] = 255
    yy, xx = np.mgrid[0:600, 0:240]
    img[(3 * yy + xx) % 50 == 0] = 0         # bars of many lengths
    calls = []
    real = ccl._ccl_features_pixels
    monkeypatch.setattr(ccl, "_ccl_features_pixels",
                        lambda *a: calls.append(1) or real(*a))
    got, want = _both(img, jccl.CclConfig(max_components=64))
    assert calls == [1]
    _assert_same_result(got, want)


def test_ccl_features_from_labels_matches(blob_img):
    lbl = jccl.label_components(jnp.asarray(blob_img))
    cfg = jccl.CclConfig(max_components=6)
    want = jccl.ccl_features_from_labels(lbl, cfg)
    got = ccl.ccl_features_from_labels(torch.from_numpy(np.array(lbl)),
                                       config_from_reference(cfg))
    _assert_same_result(got, want)


def test_ccl_features_golden(goldens):
    gray = torch.from_numpy(make_test_image())
    binary = threshold.threshold_otsu(gray)[0]
    res = ccl.ccl_features(binary, ccl.CclConfig(max_components=2048))
    assert golden.ccl_summary(res) == goldens["ccl_features_summary"]
    jres = jccl.ccl_features(jnp.asarray(binary.numpy()),
                             jccl.CclConfig(max_components=2048))
    _assert_same_result(res, jres)


def test_summary_copies_equal_originals():
    gray = make_test_image()
    binary = np.asarray(jthr.threshold_otsu(jnp.asarray(gray))[0])
    jres = jccl.ccl_features(jnp.asarray(binary),
                             jccl.CclConfig(max_components=2048))
    assert golden.ccl_summary(jres) == jgolden.ccl_summary(jres)
    port = result_from_numpy(ccl.CclResult, jres)
    assert golden.ccl_summary(port) == jgolden.ccl_summary(jres)
    from compv_tpu.features import mser as jmser
    mres = jmser.MserResult(*[np.asarray(x) for x in (
        [3, 4, 5], [1, 2, 3], [10, 20, 30], [100, 200, 300],
        [0.1, 0.2, 0.3], [0, 0, 0], [0, 0, 0], [1, 1, 1], [1, 1, 1],
        [True, False, True])], np.int32(2))
    assert golden.mser_summary(mres) == jgolden.mser_summary(mres)


def test_ccl_interop_roundtrip(blob_img):
    cfg = jccl.CclConfig(connectivity=4, max_components=7)
    assert config_from_reference(cfg) == ccl.CclConfig(connectivity=4,
                                                       max_components=7)
    jres = jccl.ccl_features(jnp.asarray(blob_img), cfg)
    port = result_from_numpy(ccl.CclResult, jres)
    assert port.area.dtype == torch.int32 and port.valid.dtype == torch.bool
    back = result_to_numpy(port)
    for name in ccl.CclResult._fields:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(jres,
                                                                     name)))
