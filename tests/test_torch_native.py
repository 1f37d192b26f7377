"""Port parity for the native host runtime (``compv_tpu_torch/native_rt.py``)
against ``compv_tpu/native_rt.py``: the aligned pool, the prefetching frame
loader, the fork-join executor, MD5 and the strided copy, as
``tests/test_native.py`` checks them, each on the native library and on the
pure-Python path (the ``path`` fixture), with the loader's frames and MD5
digests equal to the reference's on the same bytes.

The port builds ``native/compv_native.cpp`` into ``build/compv_tpu_torch/``;
the tracked ``native/libcompv_native.so`` is never written (its sha256 is
the same before and after a forced build).
"""
import hashlib
import os

import numpy as np
import pytest

from compv_tpu import native_rt as jnative
from compv_tpu_torch import native_rt
from compv_tpu_torch.native_rt import (AlignedPool, Executor, PrefetchLoader,
                                       copy_strided, md5_mat,
                                       native_available)
from compv_tpu_torch.ops.kernels._build import BUILD_DIR

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TRACKED = os.path.join(_ROOT, "native", "libcompv_native.so")


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Run the test on the native library, then on the pure-Python path
    (as where g++ is missing)."""
    if request.param == "native":
        assert native_available()
    else:
        monkeypatch.setattr(native_rt, "_lib", False)
        assert not native_available()
    return request.param


def _sha256(p):
    with open(p, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_builds_under_build_dir():
    assert native_available(), "g++ builds the runtime on this host"
    lib = native_rt.library_path()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert lib.name.startswith("compv_native-") and lib.suffix == ".so"


def test_build_never_writes_the_tracked_library(tmp_path, monkeypatch):
    before = _sha256(_TRACKED), os.stat(_TRACKED).st_mtime_ns
    monkeypatch.setattr(native_rt, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_rt, "_lib", None)
    assert native_available()
    assert native_rt.library_path().parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [
        native_rt.library_path().name]
    assert md5_mat(np.zeros((2, 3), np.uint8)) == \
        hashlib.md5(bytes(6)).hexdigest()
    assert (_sha256(_TRACKED), os.stat(_TRACKED).st_mtime_ns) == before


def test_failed_build_takes_the_python_path(tmp_path, monkeypatch):
    monkeypatch.setattr(native_rt, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_rt, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))     # no g++ on it
    assert not native_available()
    assert list(tmp_path.iterdir()) == []
    assert md5_mat(np.ones((1, 5), np.uint8)) == \
        hashlib.md5(bytes([1] * 5)).hexdigest()


class TestPool:
    def test_alloc_release_reuse(self, path):
        pool = AlignedPool(64)
        a = pool.alloc(1 << 20)
        a[:] = 7
        pool.release(a)
        b = pool.alloc(1 << 20)
        assert b.size == 1 << 20
        if path == "native":
            assert pool.stats()["hits"] >= 1  # second alloc reused the block
            assert b.ctypes.data == a.ctypes.data
        else:
            assert pool.stats() == {"hits": 0, "misses": 0, "blocks": 0,
                                    "bytes": 0}
        pool.close()

    @pytest.mark.parametrize("alignment", [64, 256, 4096])
    def test_alignment(self, alignment):
        pool = AlignedPool(alignment)
        a = pool.alloc(4096 + 3)
        assert a.ctypes.data % alignment == 0
        pool.close()


def _frames(tmp_path, h, w, n, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, (n, h, w),
                                                  dtype=np.uint8)
    p = str(tmp_path / "seq.raw")
    frames.tofile(p)
    return frames, p


class TestLoader:
    def test_reads_frames_in_order_as_the_reference(self, tmp_path, path):
        frames, p = _frames(tmp_path, 24, 32, 6)
        loader = PrefetchLoader(p, 24, 32)
        assert len(loader) == 6
        got = [f.copy() for f in loader]
        loader.close()
        ref = jnative.PrefetchLoader(p, 24, 32)
        want = [f.copy() for f in ref]
        ref.close()
        np.testing.assert_array_equal(np.stack(got), frames)
        np.testing.assert_array_equal(np.stack(got), np.stack(want))

    def test_pool_staging_recycles(self, tmp_path, path):
        frames, p = _frames(tmp_path, 16, 16, 5, seed=1)
        pool = AlignedPool()
        loader = PrefetchLoader(p, 16, 16, pool=pool)
        for i, f in enumerate(loader):
            np.testing.assert_array_equal(f, frames[i])
            loader.release(f)
        loader.close()
        if path == "native":
            s = pool.stats()
            assert s["misses"] == 1 and s["hits"] >= 4
        pool.close()

    def test_loop_mode(self, tmp_path, path):
        frames = np.stack([np.full((8, 8), i, np.uint8) for i in range(3)])
        p = str(tmp_path / "seq.raw")
        frames.tofile(p)
        loader = PrefetchLoader(p, 8, 8, loop=True)
        vals = [int(loader.next()[0, 0]) for _ in range(7)]
        assert vals == [0, 1, 2, 0, 1, 2, 0]
        loader.close()

    def test_eos(self, tmp_path, path):
        np.zeros((2, 8, 8), np.uint8).tofile(str(tmp_path / "s.raw"))
        loader = PrefetchLoader(str(tmp_path / "s.raw"), 8, 8)
        assert loader.next() is not None
        assert loader.next() is not None
        assert loader.next() is None
        loader.close()

    def test_channels(self, tmp_path, path):
        frames, p = _frames(tmp_path, 6, 4, 3 * 3, seed=2)
        loader = PrefetchLoader(p, 6, 4, channels=3)
        got = list(loader)
        loader.close()
        assert len(got) == 3 and got[0].shape == (6, 4, 3)
        np.testing.assert_array_equal(got[1].ravel(),
                                      frames.ravel()[72:144])


def test_copy_strided(path):
    src = np.arange(100, dtype=np.uint8)
    dst = np.zeros(80, np.uint8)
    copy_strided(src, 10, dst, 8, 8, 10)
    want = np.concatenate([src[i * 10: i * 10 + 8] for i in range(10)])
    np.testing.assert_array_equal(dst, want)
    ref = np.zeros(80, np.uint8)
    jnative.copy_strided(src, 10, ref, 8, 8, 10)
    np.testing.assert_array_equal(dst, ref)


class TestExecutor:
    """Fork-join pool semantics (reference CompVThreadDispatcher11:
    disjoint ranges, blocking join, nested fork runs inline)."""

    def test_covers_range_disjointly(self, path):
        ex = Executor(4)
        assert ex.num_threads == 4
        out = np.zeros(10_000, np.int64)

        def fill(b, e):
            out[b:e] += np.arange(b, e)

        ex.parallel_for(fill, 0, 10_000, 16)
        np.testing.assert_array_equal(out, np.arange(10_000))
        ex.close()

    def test_nested_fork_runs_inline(self, path):
        ex = Executor(2)
        hits = []

        def inner(b, e):
            hits.append((b, e))

        def outer(b, e):
            ex.parallel_for(inner, 0, 4)  # must not deadlock

        ex.parallel_for(outer, 0, 2)
        assert len(hits) >= 2
        ex.close()

    def test_propagates_exception(self, path):
        ex = Executor(2)

        def boom(b, e):
            raise ValueError("boom")

        with pytest.raises(ValueError):
            ex.parallel_for(boom, 0, 100)
        ex.close()

    def test_empty_range_noop(self, path):
        ex = Executor(2)
        ex.parallel_for(lambda b, e: 1 / 0, 5, 5)
        ex.close()


class TestMd5:
    """Golden hashing parity with hashlib and with the reference's
    ``md5_mat`` (row-wise, stride padding excluded;
    tests_common.cxx:98-116)."""

    def test_matches_hashlib_and_reference(self, path):
        a = np.random.default_rng(3).integers(0, 256, (37, 101)
                                              ).astype(np.uint8)
        assert md5_mat(a) == hashlib.md5(a.tobytes()).hexdigest()
        assert md5_mat(a) == jnative.md5_mat(a)
        f = np.random.default_rng(4).random((5, 7)).astype(np.float32)
        assert md5_mat(f) == jnative.md5_mat(f)

    def test_strided_skips_padding(self, path):
        a = np.random.default_rng(4).integers(0, 256, (9, 16)
                                              ).astype(np.uint8)
        got = md5_mat(a, stride=16, row_bytes=11)
        want = hashlib.md5(
            b"".join(a[r, :11].tobytes() for r in range(9))).hexdigest()
        assert got == want == jnative.md5_mat(a, stride=16, row_bytes=11)

    def test_block_boundaries(self, path):
        # every tail length around the 64-byte block size
        for n in (0, 1, 55, 56, 57, 63, 64, 65, 127, 128, 1000):
            a = (np.arange(n) % 251).astype(np.uint8)
            m = a.reshape(1, -1) if n else np.zeros((1, 0), np.uint8)
            assert md5_mat(m) == hashlib.md5(a.tobytes()).hexdigest(), n
