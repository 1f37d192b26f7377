"""ctypes bindings for the native host runtime (mirror of
``compv_tpu/native_rt.py``), built from the repository's shared C++ source
``native/compv_native.cpp``.

The library is compiled at first use with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``build/compv_tpu_torch/compv_native-<hash>.so``,
keyed by a hash of the source and the flags (as the CUDA kernels are, in
``ops/kernels/_build.py``); the tracked ``native/libcompv_native.so`` is
never written. Where ``g++`` is missing or the build fails, every class
and function runs a pure-Python version of the same contract (this is a
host library, not a device kernel); ``native_available()`` says which one
is in use, and ``library_path()`` where the native one lives.

Public surface: AlignedPool, PrefetchLoader, Executor, md5_mat,
copy_strided, native_available.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from compv_tpu_torch.ops.kernels._build import BUILD_DIR

__all__ = ["native_available", "library_path", "AlignedPool",
           "PrefetchLoader", "copy_strided", "Executor", "md5_mat"]

_RANGE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_long,
                             ctypes.c_long, ctypes.c_int)

SRC = Path(__file__).resolve().parents[1] / "native" / "compv_native.cpp"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the loaded library, or False once building or loading it has failed
_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"compv_native-{digest.hexdigest()[:16]}.so"


def _build() -> Path | None:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.compv_pool_create.restype = ctypes.c_void_p
    lib.compv_pool_create.argtypes = [ctypes.c_size_t]
    lib.compv_pool_alloc.restype = ctypes.c_void_p
    lib.compv_pool_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.compv_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.compv_pool_stats.restype = ctypes.c_uint64
    lib.compv_pool_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.compv_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.compv_loader_open.restype = ctypes.c_void_p
    lib.compv_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_int, ctypes.c_int]
    lib.compv_loader_num_frames.restype = ctypes.c_long
    lib.compv_loader_num_frames.argtypes = [ctypes.c_void_p]
    lib.compv_loader_next.restype = ctypes.c_long
    lib.compv_loader_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint8)]
    lib.compv_loader_close.argtypes = [ctypes.c_void_p]
    lib.compv_copy_strided.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_size_t]
    lib.compv_executor_create.restype = ctypes.c_void_p
    lib.compv_executor_create.argtypes = [ctypes.c_int]
    lib.compv_executor_num_threads.restype = ctypes.c_int
    lib.compv_executor_num_threads.argtypes = [ctypes.c_void_p]
    lib.compv_executor_parallel_for.argtypes = [
        ctypes.c_void_p, _RANGE_FN, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_int]
    lib.compv_executor_destroy.argtypes = [ctypes.c_void_p]
    lib.compv_md5_create.restype = ctypes.c_void_p
    lib.compv_md5_update.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_size_t]
    lib.compv_md5_update_strided.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
    lib.compv_md5_final.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    return lib


def _load():
    """The native library, built if needed; None on the pure-Python path
    (a failed build is not tried again in this process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            try:
                _lib = _declare(ctypes.CDLL(str(path))) if path else False
            except OSError:
                _lib = False
        return _lib or None


def native_available() -> bool:
    """True when the native library is in use, False on the pure-Python
    path."""
    return _load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class AlignedPool:
    """Aligned host-buffer pool (reference CompVMem pool, compv_mem.h:36-91).
    Buffers are reused by size bucket; stats expose hit/miss counts."""

    def __init__(self, alignment: int = 64):
        self._lib = _load()
        self._pool = (self._lib.compv_pool_create(alignment)
                      if self._lib else None)

    def alloc(self, size: int) -> np.ndarray:
        if self._pool:
            ptr = self._lib.compv_pool_alloc(self._pool, size)
            buf = (ctypes.c_uint8 * size).from_address(ptr)
            return np.frombuffer(buf, np.uint8)
        return np.empty(size, np.uint8)

    def release(self, arr: np.ndarray) -> None:
        # the frombuffer view's data pointer IS the pool pointer
        if self._pool:
            self._lib.compv_pool_release(
                self._pool, ctypes.c_void_p(arr.ctypes.data))

    def stats(self) -> dict:
        if not self._pool:
            return {"hits": 0, "misses": 0, "blocks": 0, "bytes": 0}
        s = self._lib.compv_pool_stats
        return {"hits": s(self._pool, 0), "misses": s(self._pool, 1),
                "blocks": s(self._pool, 2), "bytes": s(self._pool, 3)}

    def close(self) -> None:
        if self._pool:
            self._lib.compv_pool_destroy(self._pool)
            self._pool = None


class PrefetchLoader:
    """Background-thread raw-frame loader (native double-buffered IO): the
    C++ thread reads frame t+1 while frame t computes."""

    def __init__(self, path: str, height: int, width: int, channels: int = 1,
                 depth: int = 4, loop: bool = False,
                 pool: "AlignedPool | None" = None):
        self.shape = (height, width) if channels == 1 else (height, width,
                                                             channels)
        self.frame_bytes = int(np.prod(self.shape))
        self._lib = _load()
        self._h = None
        self._py = None
        self._pool = pool
        if self._lib:
            self._h = self._lib.compv_loader_open(
                path.encode(), self.frame_bytes, depth, int(loop))
        if not self._h:
            self._py = open(path, "rb")
            self._py_frames = os.path.getsize(path) // self.frame_bytes
            self._py_next = 0
            self._loop = loop

    def __len__(self):
        if self._h:
            return int(self._lib.compv_loader_num_frames(self._h))
        return self._py_frames

    def release(self, frame: np.ndarray) -> None:
        """Return a frame's staging buffer to the pool (no-op without one).
        Only call once the frame's data is consumed (e.g. on the card)."""
        if self._pool is not None:
            self._pool.release(frame.ravel())

    def next(self) -> np.ndarray | None:
        buf = (self._pool.alloc(self.frame_bytes) if self._pool is not None
               else np.empty(self.frame_bytes, np.uint8))
        if self._h:
            if self._lib.compv_loader_next(self._h, _ptr(buf)) < 0:
                return None
            return buf.reshape(self.shape)
        if self._py_next >= self._py_frames:
            if not self._loop:
                return None
            self._py.seek(0)
            self._py_next = 0
        buf[:] = np.frombuffer(self._py.read(self.frame_bytes), np.uint8)
        self._py_next += 1
        return buf.reshape(self.shape)

    def __iter__(self):
        while True:
            f = self.next()
            if f is None:
                return
            yield f

    def close(self):
        if self._h:
            self._lib.compv_loader_close(self._h)
            self._h = None
        if self._py:
            self._py.close()
            self._py = None


class Executor:
    """Native fork-join thread pool (reference CompVThreadDispatcher11 —
    one worker per core, static range splitting, nested fork runs inline;
    base/parallel/compv_threaddisp11.cxx:18-46,65) for host-side pre- and
    post-processing around the device path.

    ``parallel_for(fn, begin, end, chunks)`` calls ``fn(b, e)`` on workers
    for disjoint sub-ranges and blocks until all complete. On the
    pure-Python path a ThreadPoolExecutor does the same.
    """

    def __init__(self, n_threads: int = 0):
        self._lib = _load()
        self._h = (self._lib.compv_executor_create(n_threads)
                   if self._lib else None)
        self._py = None
        self._tl = threading.local()
        if not self._h:
            import concurrent.futures as cf
            self._py = cf.ThreadPoolExecutor(max_workers=n_threads or None)

    @property
    def num_threads(self) -> int:
        if self._h:
            return int(self._lib.compv_executor_num_threads(self._h))
        return self._py._max_workers

    def parallel_for(self, fn, begin: int, end: int, chunks: int = 0) -> None:
        if end <= begin:
            return
        if self._h:
            exc = []

            @_RANGE_FN
            def trampoline(_arg, b, e, _worker):
                try:
                    fn(int(b), int(e))
                except BaseException as err:  # noqa: BLE001 - re-raised below
                    exc.append(err)

            self._lib.compv_executor_parallel_for(
                self._h, trampoline, None, begin, end, chunks)
            if exc:
                raise exc[0]
            return
        if getattr(self._tl, "in_worker", False):
            fn(begin, end)  # nested fork runs inline (reference forbids it)
            return
        n = end - begin
        chunks = min(chunks or self.num_threads, n)
        per, extra = divmod(n, chunks)

        def run(b, e):
            self._tl.in_worker = True
            try:
                fn(b, e)
            finally:
                self._tl.in_worker = False

        futs, b = [], begin
        for c in range(chunks):
            e = b + per + (1 if c < extra else 0)
            futs.append(self._py.submit(run, b, e))
            b = e
        for f in futs:
            f.result()

    def close(self) -> None:
        if self._h:
            self._lib.compv_executor_destroy(self._h)
            self._h = None
        if self._py:
            self._py.shutdown()
            self._py = None


def md5_mat(arr: np.ndarray, stride: int | None = None,
            row_bytes: int | None = None) -> str:
    """MD5 hex digest of a matrix, row-wise ignoring stride padding — the
    reference's golden-test hash (compv_tests_md5, tests_common.cxx:98-116).
    Native; hashlib on the pure-Python path."""
    a = np.ascontiguousarray(arr)
    flat = a.reshape(a.shape[0], -1).view(np.uint8) if a.ndim > 1 else \
        a.view(np.uint8).reshape(1, -1)
    rows, rb = flat.shape
    stride = stride if stride is not None else rb
    row_bytes = row_bytes if row_bytes is not None else rb
    lib = _load()
    if lib:
        h = lib.compv_md5_create()
        lib.compv_md5_update_strided(h, _ptr(flat), stride, row_bytes, rows)
        out = ctypes.create_string_buffer(33)
        lib.compv_md5_final(h, out)
        return out.value.decode()
    h = hashlib.md5()
    raw = flat.tobytes()
    for r in range(rows):
        h.update(raw[r * stride: r * stride + row_bytes])
    return h.hexdigest()


def copy_strided(src: np.ndarray, src_stride: int, dst: np.ndarray,
                 dst_stride: int, row_bytes: int, rows: int) -> None:
    """Stride-removal copy (reference CompVImage::wrap)."""
    lib = _load()
    if lib:
        lib.compv_copy_strided(_ptr(src), src_stride, _ptr(dst), dst_stride,
                               row_bytes, rows)
        return
    for r in range(rows):
        dst[r * dst_stride: r * dst_stride + row_bytes] = \
            src[r * src_stride: r * src_stride + row_bytes]
