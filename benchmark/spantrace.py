"""The profiler slice laid against the program's own spans.

The program records its spans in memory on the profiler's clock
(``compv_tpu_torch.profiling.spans``); nothing of them goes into the
profiler. Here each device kernel goes to the innermost span open on the
host when its launch call ran (the ``cuda*`` / ``cu*`` API event with the
kernel's correlation id), each synchronizing call to the span open when
it started, and each device-idle gap of 10 us or more, found as
``devtrace._idle_gaps`` finds them, to the span open at the gap's start.
``spanrun.py`` runs a cell with the store on and prints the result.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

from benchmark import devtrace

OUTSIDE = "outside the program"
UNLINKED = "launch not found"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
HOST_API = re.compile(r"cu(da)?[A-Z]")    # cudaLaunchKernel, cuLaunchKernel
GAP_NS = 10_000
COLUMNS = ("kernels", "device_ns", "syncs", "idle_ns", "host_self_ns")


def is_sync(name: str) -> bool:
    """A call that makes the host wait for the device: a stream, device or
    event synchronize, or a copy that is not ``Async``."""
    return name in SYNC_CALLS or (name.startswith("cudaMemcpy")
                                  and "Async" not in name)


def innermost(spans) -> tuple:
    """The host timeline cut where the innermost open span changes:
    (times, ids), ``ids[i]`` open from ``times[i]`` (None: no span). The
    spans are one thread's, so they nest."""
    times, ids, stack = [], [], []

    def mark(t, sid):
        if times and times[-1] == t:
            ids[-1] = sid
        else:
            times.append(t)
            ids.append(sid)

    def close_until(t):
        while stack and stack[-1].end_ns <= t:
            top = stack.pop()
            mark(top.end_ns, stack[-1].id if stack else None)

    for r in sorted(spans, key=lambda r: (r.start_ns, -r.end_ns)):
        close_until(r.start_ns)
        stack.append(r)
        mark(r.start_ns, r.id)
    close_until(float("inf"))
    return times, ids


def _at(timeline, t):
    times, ids = timeline
    i = bisect.bisect_right(times, t) - 1
    return ids[i] if i >= 0 else None


def reduce_by_span(raw: dict, spans, frames: int) -> dict:
    """By span name (``rows``), by name and pyramid level (``levels``,
    ``name[level]``) and by request, under the name of the request's
    outermost span (``requests``): kernels, their device ns, synchronizing
    calls, idle ns in gaps of 10 us or more, and host self ns. ``rows``
    has an ``outside the program`` row (and a ``launch not found`` row for
    kernels whose launch call the slice lacks), so each column sums to
    ``total``; host self time sums to the slice's wall."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_id = {r.id: r for r in spans}
    timeline = innermost(spans)
    launch_ns, sync_ns, ops, kernels = {}, [], [], []
    for ev in raw["events"]:
        if ev.device_type() == cuda:
            name = ev.name()
            if name.startswith("bench."):
                continue            # the benchmark's own ranges
            s = ev.start_ns()
            e = s + ev.duration_ns()
            ops.append((s, e))
            if not name.startswith(("Memcpy", "Memset")):
                kernels.append((s, e, ev.correlation_id()))
        else:
            name = ev.name()
            if HOST_API.match(name):        # a CUDA API call
                t = ev.start_ns()
                launch_ns[ev.correlation_id()] = t
                if is_sync(name):
                    sync_ns.append(t)

    rows = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))
    levels = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))
    requests = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))

    def add(sid, column, value, missing=OUTSIDE):
        if sid is None:
            rows[missing][column] += value
            return
        r = by_id[sid]
        rows[r.name][column] += value
        if "level" in r.attrs:
            levels[f"{r.name}[{r.attrs['level']}]"][column] += value
        requests[by_id[r.request].name][column] += value

    for s, e, corr in kernels:
        t = launch_ns.get(corr)
        sid, missing = ((None, UNLINKED) if t is None
                        else (_at(timeline, t), OUTSIDE))
        add(sid, "kernels", 1, missing)
        add(sid, "device_ns", e - s, missing)
    for t in sync_ns:
        add(_at(timeline, t), "syncs", 1)
    _, merged = devtrace._union(ops)
    idle = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 - e0 >= GAP_NS:
            add(_at(timeline, e0), "idle_ns", s1 - e0)
            idle += s1 - e0
    from compv_tpu_torch.profiling import span_self_ns
    own = span_self_ns(spans)
    for r in spans:
        add(r.id, "host_self_ns", own[r.id])
    wall_ns = int(raw["wall_s"] * 1e9)
    rooted = sum(r.end_ns - r.start_ns for r in spans if r.parent is None)
    rows[OUTSIDE]["host_self_ns"] += max(wall_ns - rooted, 0)
    total = {"kernels": len(kernels),
             "device_ns": sum(e - s for s, e, _ in kernels),
             "syncs": len(sync_ns), "idle_ns": idle,
             "host_self_ns": max(wall_ns, rooted)}
    return {"rows": dict(rows), "levels": dict(levels),
            "requests": dict(requests), "total": total, "frames": frames}


def table(by_span: dict) -> str:
    """``rows`` and ``levels`` as text: per frame, ms and counts."""
    f = max(by_span["frames"], 1)
    lines = [f"{'span':<28}{'host self ms':>13}{'kernels':>10}"
             f"{'device ms':>11}{'syncs':>7}{'idle ms':>10}  (a frame)"]
    for part in ("rows", "levels"):
        for name, c in sorted(by_span[part].items(),
                              key=lambda kv: -kv[1]["host_self_ns"]):
            lines.append(f"{name:<28}{c['host_self_ns'] / 1e6 / f:>13.3f}"
                         f"{c['kernels'] / f:>10.1f}"
                         f"{c['device_ns'] / 1e6 / f:>11.3f}"
                         f"{c['syncs'] / f:>7.2f}"
                         f"{c['idle_ns'] / 1e6 / f:>10.3f}")
    return "\n".join(lines)


def window_line(records, frames: int) -> str:
    """The window's spans by name: ms a frame, total / self."""
    from compv_tpu_torch.profiling import span_totals
    rows = sorted(span_totals(records).items(),
                  key=lambda kv: -kv[1]["self_ns"])
    return ", ".join(f"{name} {t['total_ns'] / 1e6 / frames:.3f} / "
                     f"{t['self_ns'] / 1e6 / frames:.3f}"
                     for name, t in rows)

