"""Profiling, tracing and logging helpers (mirror of
``compv_tpu/profiling.py``).

The reference library has millisecond timers around sections and
log-based annotations (CompVTime::nowMillis, CompVDebugMgr). Here:
  * Timer / timed(): wall-clock section timers; a section given a result
    waits for every CUDA device that result lives on.
  * span() / spans: the program's own spans, placed where the work happens
    (the frontend pair, ORB and its sub-stages by pyramid level, the
    matcher, the homography). Off by default, when a span costs one call
    and one flag test; ``spans.enable()`` records each span in memory with
    its parent and request, stamped on ``torch.profiler``'s clock, and
    never waits on the device. ``span_totals`` gives calls, total and self
    time by name.
  * host_syncs(): a cumulative counter of the host's reads of device
    values (``bool(t)``, ``int(t)``: each waits for the device) with the
    calls they were made in, by entry point (``ccl_features``,
    ``mser_detect``); always on, one dict update a call.
  * trace(): a ``torch.profiler`` window written as a Chrome trace file,
    checked against the hand kernels' launch counters: a window that
    holds fewer of their device kernels than their wrappers launched
    warns (``RuntimeWarning``) and says which in ``prof.shortfall``. The
    window's spans are recorded too (``prof.spans``) and written into the
    file as a track of their own, on the trace's clock, so Perfetto shows
    them above the kernels they launched.
  * device_memory_stats(): memory in use per CUDA device.
  * log: leveled logger with pluggable sinks (compv_debug.h:32-59).
``trace`` and ``device_memory_stats`` ask for the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time
import warnings
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from compv_tpu_torch.device import require_cuda
from compv_tpu_torch.ops.kernels import _build

__all__ = ["Timer", "timed", "SpanRecord", "SpanStore", "spans", "span",
           "span_self_ns", "span_totals", "trace", "device_memory_stats",
           "Log", "log"]


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


class SpanRecord(NamedTuple):
    """One closed span. ``parent`` is None for a span opened with no span
    open on its thread; such a span starts a request, and ``request`` is
    its id, shared by every span opened inside it. Times are ns on
    ``torch.profiler``'s clock (the Unix epoch)."""
    id: int
    parent: Optional[int]
    request: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


def _clock_offset_ns(reads: int = 5) -> int:
    """``time.time_ns() - time.perf_counter_ns()`` from the tightest of a
    few paired reads: the profiler stamps its events on the Unix epoch,
    and ``perf_counter_ns`` keeps durations monotonic."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


class _Off:
    """The span of a store that is off. Its ``__enter__`` and ``__exit__``
    are C functions that take any arguments and return "" (falsy, so an
    exception passes through): a ``with`` on it runs no Python code."""
    __slots__ = ()
    __enter__ = "".format
    __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("store", "name", "attrs", "id", "parent", "request",
                 "offset", "start_ns", "stack")

    def __init__(self, store: "SpanStore", name: str, attrs: dict):
        self.store = store
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        store = self.store
        stack = store._stack()
        self.id = next(store._ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.stack = stack
        self.offset = store._offset_ns
        self.start_ns = time.perf_counter_ns() + self.offset
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns() + self.offset
        self.stack.pop()
        self.store._records.append(SpanRecord(
            self.id, self.parent, self.request, self.name, self.start_ns,
            end_ns, self.attrs))
        return False


class SpanStore:
    """The program's spans, kept in memory. Off until ``enable()``; each
    thread keeps its own stack of open spans. Records are kept in the
    order the spans closed."""

    def __init__(self):
        self.on = False
        self._records: List[SpanRecord] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._offset_ns = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def now_ns(self) -> int:
        """Now, on the spans' clock."""
        return time.perf_counter_ns() + self._offset_ns

    def enable(self) -> None:
        """Clear the records and record every span opened from now on."""
        self._offset_ns = _clock_offset_ns()
        self._records = []
        self.on = True

    def disable(self) -> None:
        """Record no span opened from now on (one open now still closes
        into the records)."""
        self.on = False

    def take(self) -> List[SpanRecord]:
        """The records so far; the store keeps none of them."""
        out, self._records = self._records, []
        return out


spans = SpanStore()


def span(name: str, **attrs):
    """A span named ``name`` around a ``with`` block. With the store off
    (the default) it records nothing and reads no clock; on, it records
    the block's start and end on the host, never waiting on the device,
    so the span holds the block's host work and the launches of the
    device work it queued."""
    if not spans.on:
        return _OFF
    return _Span(spans, name, attrs)


def span_self_ns(records: List[SpanRecord]) -> Dict[int, int]:
    """Each span's self time in ns, by id: its duration less the part of
    its interval that its child spans cover."""
    children = defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append((r.start_ns, r.end_ns))
    out = {}
    for r in records:
        covered, last = 0, r.start_ns
        for s, e in sorted(children.get(r.id, ())):
            s, e = max(s, last), min(e, r.end_ns)
            if e > s:
                covered += e - s
                last = e
        out[r.id] = r.end_ns - r.start_ns - covered
    return out


def span_totals(records: List[SpanRecord]) -> Dict[str, dict]:
    """By span name: ``calls``, ``total_ns`` (summed durations) and
    ``self_ns`` (summed self times)."""
    own = span_self_ns(records)
    out: Dict[str, dict] = {}
    for r in records:
        row = out.setdefault(r.name, {"calls": 0, "total_ns": 0,
                                      "self_ns": 0})
        row["calls"] += 1
        row["total_ns"] += r.end_ns - r.start_ns
        row["self_ns"] += own[r.id]
    return out


_TRACE_IDS = itertools.count()


def hand_kernel_launches() -> Dict[str, int]:
    """The hand kernels' launch counters, by the name of the one device
    kernel that each counted launch runs (the rows of
    ``ops/kernels/_build.KERNELS``: K1-K5, ORB's orientation kernel K6 and
    MSER's ladder level areas K7)."""
    return _build.launch_counts()


_HOST_SYNCS: Dict[str, List[int]] = {}


def count_host_syncs(entry: str, syncs: int) -> None:
    """Count one call of ``entry`` that read ``syncs`` device values on
    the host."""
    row = _HOST_SYNCS.setdefault(entry, [0, 0])
    row[0] += 1
    row[1] += syncs


def host_syncs() -> Dict[str, dict]:
    """The host-sync counter since the process started, by entry point:
    ``{"calls": n, "syncs": s}``."""
    return {e: {"calls": c, "syncs": s} for e, (c, s) in _HOST_SYNCS.items()}


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


_SPAN_TID = 1 << 30        # the spans' own row in the Chrome trace


def _write_span_track(path: str, records: List[SpanRecord]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as complete events
    on a thread row of their own under this process. The file's times are
    µs after its ``baseTimeNanoseconds`` (0 where it names none) on the
    profiler's clock, which the spans share."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": _SPAN_TID,
                   "args": {"name": "compv_tpu_torch spans"}})
    for r in records:
        events.append({"ph": "X", "cat": "compv_span", "name": r.name,
                       "pid": pid, "tid": _SPAN_TID,
                       "ts": (r.start_ns - base) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3,
                       "args": {"id": r.id, "parent": r.parent,
                                "request": r.request, **r.attrs}})
    with open(path, "w") as f:
        json.dump(doc, f)


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
    shortfall warns. The span store records the window (a store already
    on keeps its records): ``prof.spans`` holds the spans opened in it,
    and the file has them as a track of their own."""
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
    own_store = not spans.on
    if own_store:
        spans.enable()
    opened = spans.now_ns()
    try:
        with profile(activities=activities) as prof:
            if on_card:
                _first_kernel()
            try:
                yield prof
            finally:
                if on_card:
                    torch.cuda.synchronize()
    finally:
        if own_store:
            spans.disable()
            records = spans.take()
        else:
            records = list(spans._records)
    prof.export_chrome_trace(path)
    prof.trace_path = path
    prof.spans = [r for r in records if r.start_ns >= opened]
    _write_span_track(path, prof.spans)
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
