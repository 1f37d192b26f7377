"""Build a CUDA source of ``compv_tpu_torch/csrc`` into a shared library
with a plain C interface, at first use, and load it with ctypes.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
writes ``build/compv_tpu_torch/<name>-<hash>.so`` under the checkout, keyed
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The compiler's report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside it as ``.log``. A missing
``nvcc`` or a compile error raises; nothing falls back. Processes that build
one source at once (the ranks of a process group) take turns on a lock file
beside it (``flock``, released when its holder exits), so one compiles and
the others load its library.

It also holds what the rest of the port knows of the hand kernels: the table
``KERNELS`` (one row a counted device kernel), the ``Library`` through which
a wrapper declares its entry points' C signatures once, ``Entry.launch``,
the one launch path (the tensor's device, the current stream's handle
appended, a non-zero return raised, one launch counted), and the counters,
read by ``launch_counts`` and cleared by ``reset_launch_counts``. A new hand
kernel is one row of the table.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["CSRC", "BUILD_DIR", "KERNELS", "LIBRARIES", "Entry", "Kernel",
           "Library", "build", "find_nvcc", "launch_counts", "library_path",
           "load", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "compv_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the first on PATH; raises RuntimeError when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # built while this process waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))


class Kernel(NamedTuple):
    """One counted device kernel: its id, the name of the device kernel a
    counted launch runs (the name the profiler shows), its ``csrc/`` source
    and the Pallas function it replaces (None where it replaces none)."""
    id: str
    name: str
    source: str
    replaces: str | None


KERNELS = (
    Kernel("K1", "fast_kernel", "fast_kernel",
           "compv_tpu/ops/pallas/fast_kernel.py:129"),
    Kernel("K2a", "label_tiles", "ccl_kernel",
           "compv_tpu/ops/pallas/ccl_kernel.py:149"),
    Kernel("K2b", "merge_seeded", "ccl_kernel",
           "compv_tpu/ops/pallas/ccl_kernel.py:171"),
    Kernel("K3", "compact", "compact_kernel",
           "compv_tpu/ops/pallas/compact_kernel.py:47"),
    Kernel("K4", "sht_accumulate", "hough_kernel",
           "compv_tpu/ops/pallas/hough_kernel.py:74"),
    Kernel("K5", "strip_counts", "label_stats",
           "compv_tpu/ops/pallas/label_stats.py:58"),
    Kernel("K6", "orb_orient", "orient_kernel", None),
    Kernel("K7", "level_areas", "level_areas", None),
)

# launches since the counters were last cleared, by device kernel name
_COUNTS = dict.fromkeys((k.name for k in KERNELS), 0)
# each source's Library by name, declared by its wrapper: the module of the
# source's name in this package
LIBRARIES = {}


def launch_counts(key: str = "name") -> dict:
    """The hand kernels' launch counters in the table's order, keyed by
    each row's ``key`` field: the device kernel's name, or ``"id"``."""
    return {getattr(k, key): _COUNTS[k.name] for k in KERNELS}


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


class Entry:
    """One C entry point of a ``Library``. A launch entry (``counts`` names
    a row of ``KERNELS``) takes the stream's handle last and returns a
    ``cudaError_t``; any other entry is a query, called as it is."""
    __slots__ = ("name", "argtypes", "restype", "counts", "fn", "library")

    def __init__(self, library, name, argtypes, restype, counts):
        self.name, self.argtypes, self.restype = name, argtypes, restype
        self.counts, self.library, self.fn = counts, library, None

    def __call__(self, *args):
        if self.fn is None:
            self.library.load()
        return self.fn(*args)

    def launch(self, device, *args) -> None:
        """Run the entry on ``device`` with the current stream's handle
        appended to ``args``; raise on a non-zero return, else count one
        launch of its kernel."""
        if self.fn is None:
            self.library.load()
        with torch.cuda.device(device):
            rc = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        _COUNTS[self.counts] += 1


class Library:
    """The entry points of ``csrc/<source>.cu``, declared once; the library
    is built and loaded at the first call of any of them, its signatures
    set, and ``check`` (if given) run once on it."""

    def __init__(self, source: str, check=None):
        self.source, self.check, self.entries = source, check, []
        LIBRARIES[source] = self

    def entry(self, name: str, argtypes, restype=ctypes.c_int,
              counts: str | None = None) -> Entry:
        """Declare entry ``name``; for a launch, ``counts`` names its
        kernel and ``argtypes`` end with the stream's ``c_void_p``."""
        if counts is not None and counts not in _COUNTS:
            raise ValueError(f"{counts!r} is no kernel of KERNELS")
        e = Entry(self, name, list(argtypes), restype, counts)
        self.entries.append(e)
        return e

    def load(self) -> None:
        lib = load(self.source)
        fns = []
        for e in self.entries:
            fn = getattr(lib, e.name)
            fn.argtypes, fn.restype = e.argtypes, e.restype
            fns.append(fn)
        for e, fn in zip(self.entries, fns):
            e.fn = fn
        if self.check is not None:
            try:
                self.check()
            except BaseException:
                for e in self.entries:
                    e.fn = None
                raise
