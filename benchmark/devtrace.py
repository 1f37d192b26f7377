"""The profiler slice of a traced run and its reduction to device numbers.

A fixed number of requests runs under ``torch.profiler`` (host and CUDA
activity). From the slice's events: the device's busy time (the union of
kernel, copy and set intervals), the slice's wall, the kernel count, the
device time of the kernels launched inside each ``bench.<stage>`` range
(read from the range's span on the device's timeline), the ten device
operations
that took most time, and the idle gaps by what the host was doing. The
hand kernels' launch counters are compared with the kernels the slice
holds; a window that lost records says so.
"""
from __future__ import annotations

import bisect
import re
import sys
import time
from collections import defaultdict


def _first_kernel():
    """A kernel of the slice's own, waited for: a profiler window on the
    card can lose its first kernel records."""
    import torch
    torch.zeros(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def run_slice(serve, n_requests: int, probe, launch_counters):
    """Run ``serve(i)`` for i in range(n_requests) under the profiler;
    returns the raw slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = launch_counters()
    probe.slicing = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _first_kernel()
        t0 = time.perf_counter_ns()
        for i in range(n_requests):
            serve(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    probe.slicing = False
    after = launch_counters()
    return {"events": prof.profiler.kineto_results.events(),
            "wall_s": (t1 - t0) / 1e9,
            "launched": {k: after[k] - before[k] for k in after}}


def _is_device(ev) -> bool:
    import torch
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _union(intervals):
    total = 0
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                total += e - merged[-1][1]
                merged[-1][1] = e
        else:
            merged.append([s, e])
            total += e - s
    return total, merged


def reduce_slice(raw: dict, frames: int) -> dict:
    """The slice's numbers: busy_s, window_s, kernels, launches a frame,
    device ns by stage, top device ops, idle gaps, shortfall.

    The profiler puts each ``bench.<stage>`` range on the device's
    timeline too (a GPU user annotation from the first to the last kernel
    launched inside it); those spans are no device work. A kernel belongs
    to a stage when it starts inside one of the stage's device spans: one
    stream runs the kernels in launch order, so these are the kernels
    launched inside the range."""
    ops, dev_spans, host_ranges, cpu_ops = [], defaultdict(list), \
        defaultdict(list), []
    for ev in raw["events"]:
        name = ev.name()
        s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if _is_device(ev):
            if name.startswith("bench."):
                dev_spans[name[6:]].append((s, e))
            else:
                ops.append((s, e, name))
        elif name.startswith("bench."):
            host_ranges[name[6:]].append((s, e))
        else:
            cpu_ops.append((s, e, name))
    if not ops:
        return {}
    busy_ns, merged = _union([(s, e) for s, e, _ in ops])
    kernels = [op for op in ops if not op[2].startswith(("Memcpy", "Memset"))]
    kernels.sort()
    k_starts = [k[0] for k in kernels]
    by_stage = {}
    for stage, spans in dev_spans.items():
        _, spans = _union(spans)
        total = found = 0
        for s, e in spans:
            i = bisect.bisect_left(k_starts, s)
            while i < len(kernels) and kernels[i][0] <= e:
                total += kernels[i][1] - kernels[i][0]
                found += 1
                i += 1
        by_stage[stage] = {"device_ns": total, "kernels": found}
    by_name = defaultdict(int)
    for s, e, name in ops:
        by_name[name[:160]] += e - s    # kernel names run to thousands
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = _idle_gaps(merged, cpu_ops, host_ranges)
    names = [k[2] for k in kernels]
    shortfall = {}
    for kname, n in raw["launched"].items():
        pat = re.compile(rf"(^|[\s:]){kname}[<(]")
        seen = sum(1 for k in names if pat.search(k))
        if seen < n:
            shortfall[kname] = (n, seen)
    if shortfall:
        print(f"profiler slice lost kernel records, (launched, traced) by "
              f"hand kernel: {shortfall}", file=sys.stderr, flush=True)
    return {"busy_s": busy_ns / 1e9, "window_s": raw["wall_s"],
            "kernels": len(kernels), "frames": frames,
            "by_stage": by_stage, "shortfall": shortfall,
            "device_ops": [[n, ns / 1e9] for n, ns in top_ops],
            "idle_gaps": gaps}


def _idle_gaps(merged, cpu_ops, ranges, min_ns: int = 10_000):
    """Idle device time between busy intervals, summed by what the host
    was doing at the gap's start: the innermost ``bench.`` stage and the
    innermost host op running then; the ten largest sums."""
    cpu_ops.sort()
    starts = [op[0] for op in cpu_ops]
    stage_spans = sorted((s, e, st) for st, rs in ranges.items()
                         for s, e in rs)
    stage_starts = [s[0] for s in stage_spans]
    sums = defaultdict(int)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        if gap < min_ns:
            sums["gaps under 10 us"] += gap
            continue
        stage = "outside stages"
        j = bisect.bisect_right(stage_starts, e0) - 1
        for k in range(j, max(j - 50, -1), -1):
            if stage_spans[k][1] >= e0:
                stage = stage_spans[k][2]
                break
        op = "Python between host ops"
        i = bisect.bisect_right(starts, e0) - 1
        for k in range(i, max(i - 200, -1), -1):
            s, e, name = cpu_ops[k]
            if e >= e0:
                op = name
                break
        sums[f"{stage} / {op}"] += gap
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:10]
    return [[n, ns / 1e9] for n, ns in top]
