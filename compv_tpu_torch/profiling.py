"""Profiling, tracing and logging helpers (mirror of
``compv_tpu/profiling.py``).

The reference library has millisecond timers around sections and
log-based annotations (CompVTime::nowMillis, CompVDebugMgr). Here:
  * Timer / timed(): wall-clock section timers; a section given a result
    waits for every CUDA device that result lives on.
  * trace(): a ``torch.profiler`` window written as a Chrome trace file,
    checked against the hand kernels' launch counters: a window that
    holds fewer of their device kernels than their wrappers launched
    warns (``RuntimeWarning``) and says which in ``prof.shortfall``.
  * device_memory_stats(): memory in use per CUDA device.
  * log: leveled logger with pluggable sinks (compv_debug.h:32-59).
``trace`` and ``device_memory_stats`` ask for the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import re
import time
import warnings
from typing import Callable, Dict, List

import torch

from compv_tpu_torch.device import require_cuda

__all__ = ["Timer", "timed", "trace", "device_memory_stats", "Log", "log"]


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):     # NamedTuple results too
        for v in tree:
            _cuda_devices(v, found)
    return found


def _synchronize(tree) -> None:
    """Wait for every CUDA device that a tensor of ``tree`` (a tensor, or
    nested tuples / NamedTuples / lists / dicts of them) lives on."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating section timer (ms), waiting for device work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        """Time the block; the CUDA devices of ``block_on``'s tensors are
        synchronized before the clock stops. The tree is walked when the
        block ends, so a list that the block fills is waited for too."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _synchronize(block_on)
        dt = (time.perf_counter() - t0) * 1000.0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            lines.append(f"{k}: {self.totals[k]:.2f} ms total, "
                         f"{self.totals[k] / n:.3f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(name: str = "section"):
    t0 = time.perf_counter()
    yield
    print(f"[compv_tpu_torch] {name}: "
          f"{(time.perf_counter() - t0) * 1000:.2f} ms")


_TRACE_IDS = itertools.count()


def hand_kernel_launches() -> Dict[str, int]:
    """The hand kernels' launch counters, by the name of the one device
    kernel that each counted launch runs (K1, K2a, K2b, K3, K4, K5)."""
    from compv_tpu_torch.ops.kernels import (ccl_kernel, compact_kernel,
                                             fast_kernel, hough_kernel,
                                             label_stats)
    return {"fast_kernel": fast_kernel.launches,
            "label_tiles": ccl_kernel.ccl_label.launches,
            "merge_seeded": ccl_kernel.ccl_label_seeded.launches,
            "compact": compact_kernel.compact_rows.launches,
            "sht_accumulate": hough_kernel.sht_accumulate.launches,
            "strip_counts": label_stats.strip_label_counts.launches}


def window_shortfall(launched: Dict[str, int],
                     kernel_names: List[str]) -> Dict[str, tuple]:
    """{kernel: (launched, traced)} for each hand kernel of which the
    device-kernel names of a window (demangled, as ``void (anonymous
    namespace)::fast_kernel<9, 32, false>(...)``) hold fewer than
    ``launched`` says."""
    out = {}
    for name, n in launched.items():
        pattern = re.compile(rf"(^|[\s:]){name}[<(]")
        traced = sum(1 for k in kernel_names if pattern.search(k))
        if traced < n:
            out[name] = (n, traced)
    return out


def _first_kernel() -> None:
    """A kernel of the window's own, waited for: a window on the card can
    lose its first kernel (the one K1 launch of a window, the first of 48
    K1 launches of another; H100, ``chip_smoke.py`` phase 19 and
    ``tests/test_torch_cuda.py``)."""
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, device: str = "cuda"):
    """Profile the block with ``torch.profiler`` (host and, on the card,
    CUDA activity) and write it to ``logdir`` as a Chrome trace
    (``trace_<pid>_<n>.json``, readable by Perfetto and chrome://tracing).
    Yields the profiler; its ``trace_path`` names the file once the block
    has ended. On the card, the work queued before the block is waited for
    before the window opens, and the block's work before it closes; then
    the window's device kernels are counted against the hand kernels'
    launch counters: ``prof.shortfall`` lists each hand kernel the window
    holds fewer of than were launched in it (``window_shortfall``), and a
    shortfall warns."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = device != "cpu"
    if on_card:
        require_cuda()
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json")
    before = hand_kernel_launches()
    with profile(activities=activities) as prof:
        if on_card:
            _first_kernel()
        try:
            yield prof
        finally:
            if on_card:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    prof.trace_path = path
    prof.shortfall = {}
    if on_card:
        after = hand_kernel_launches()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        prof.shortfall = window_shortfall(
            {k: after[k] - before[k] for k in after}, names)
        if prof.shortfall:
            warnings.warn(f"the trace window {path} holds fewer device "
                          f"kernels than were launched in it, (launched, "
                          f"traced) by kernel: {prof.shortfall}",
                          RuntimeWarning, stacklevel=3)


def device_memory_stats(device: str = "cuda") -> List[dict]:
    """One entry per CUDA device: tensor memory the allocator holds in use
    and the device's total memory, in bytes. With ``device="cpu"``: one
    entry for the host, both -1 (as the reference reports a device without
    statistics)."""
    if device == "cpu":
        return [{"device": "cpu", "bytes_in_use": -1, "bytes_limit": -1}]
    require_cuda()
    out = []
    for i in range(torch.cuda.device_count()):
        out.append({"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1]})
    return out


class Log:
    """Leveled logger with pluggable sinks (CompVDebugMgr analogue)."""

    LEVELS = {"verbose": 0, "info": 1, "warn": 2, "error": 3, "fatal": 4}

    def __init__(self):
        self.level = "info"
        self.sinks: Dict[str, List[Callable[[str], None]]] = {}

    def add_sink(self, level: str, fn: Callable[[str], None]) -> None:
        self.sinks.setdefault(level, []).append(fn)

    def _emit(self, level: str, msg: str) -> None:
        if self.LEVELS[level] < self.LEVELS[self.level]:
            return
        line = f"[compv_tpu_torch {level.upper()}] {msg}"
        sinks = self.sinks.get(level)
        if sinks:
            for fn in sinks:
                fn(line)
        else:
            print(line, flush=True)   # logs must survive piped/buffered IO

    def verbose(self, msg):
        self._emit("verbose", msg)

    def info(self, msg):
        self._emit("info", msg)

    def warn(self, msg):
        self._emit("warn", msg)

    def error(self, msg):
        self._emit("error", msg)


log = Log()
