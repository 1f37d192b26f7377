"""The slice laid against the program's spans (``spantrace``), on events
made up here, and ``spanrun.py``'s window on the CPU."""
import io
import json
from contextlib import redirect_stdout

import torch

from benchmark import spanrun, spantrace
from compv_tpu_torch.profiling import SpanRecord

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The part of a kineto event that the reducers read."""

    def __init__(self, name, start, dur, device=CPU, corr=0):
        self._v = (name, start, dur, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def launch(t, corr):
    return Ev("cudaLaunchKernel", t, 2_000, corr=corr)


def kernel(name, t, dur, corr):
    return Ev(name, t, dur, CUDA, corr)


# one request: match_pair [0, 1000 us) > orb [10, 600) > orb.detect level 0
# [20, 200) and orb.orient level 0 [200, 500); homography [700, 900)
US = 1_000
SPANS = [SpanRecord(2, 1, 1, "orb", 10 * US, 600 * US, {}),
         SpanRecord(3, 2, 1, "orb.detect", 20 * US, 200 * US, {"level": 0}),
         SpanRecord(4, 2, 1, "orb.orient", 200 * US, 500 * US, {"level": 0}),
         SpanRecord(5, 1, 1, "homography", 700 * US, 900 * US, {}),
         SpanRecord(1, None, 1, "frontend.match_pair", 0, 1000 * US, {})]
EVENTS = [
    launch(30 * US, 11), kernel("fast_kernel", 100 * US, 10 * US, 11),
    launch(250 * US, 12), kernel("add", 120 * US, 5 * US, 12),
    launch(550 * US, 13), kernel("fill", 400 * US, 50 * US, 13),
    Ev("cudaMemcpyAsync", 710 * US, 1 * US, corr=14),
    Ev("Memcpy DtoH", 450 * US, 2 * US, CUDA, 14),
    Ev("cudaStreamSynchronize", 720 * US, 30 * US, corr=15),
    Ev("cudaMemcpy", 1100 * US, 3 * US, corr=16),
    kernel("lost", 455 * US, 5 * US, 99),             # no launch call found
    launch(1200 * US, 17), kernel("after", 1300 * US, 1 * US, 17),
    Ev("bench.orb", 100 * US, 400 * US, CUDA, 0),
    Ev("aten::add", 240 * US, 20 * US, corr=13),      # a CPU op's own id
    Ev("custom_range", 560 * US, 20 * US, corr=17)]


def test_reduce_by_span_puts_work_in_the_innermost_span():
    got = spantrace.reduce_by_span(
        {"events": EVENTS, "wall_s": 1.4e-3}, SPANS, frames=1)
    rows = got["rows"]
    assert rows["orb.detect"]["kernels"] == 1           # launched at 30 us
    assert rows["orb.detect"]["device_ns"] == 10 * US
    assert rows["orb.orient"]["kernels"] == 1            # launched at 250
    assert rows["orb"]["kernels"] == 1                   # at 550: orb itself
    assert rows["launch not found"]["kernels"] == 1
    assert rows["outside the program"]["kernels"] == 1   # at 1200
    assert rows["homography"]["syncs"] == 1              # the Async copy no
    assert rows["outside the program"]["syncs"] == 1     # cudaMemcpy at 1100
    # busy: [100,110) [120,125) [400,450) [450,452) [455,460) [1300,1301);
    # gaps of 10 us or more start at 110 (detect), 125 (detect), 460 (orient)
    assert rows["orb.detect"]["idle_ns"] == 10 * US + 275 * US
    assert rows["orb.orient"]["idle_ns"] == 840 * US
    assert got["levels"]["orb.detect[0]"]["kernels"] == 1
    req = got["requests"]["frontend.match_pair"]
    assert req["kernels"] == 3 and req["syncs"] == 1
    assert req["idle_ns"] == got["total"]["idle_ns"]
    # self times: match_pair 1000 - 590 - 200, orb 590 - 480
    assert rows["frontend.match_pair"]["host_self_ns"] == 210 * US
    assert rows["orb"]["host_self_ns"] == 110 * US
    assert rows["outside the program"]["host_self_ns"] == 400 * US
    for col in spantrace.COLUMNS:
        assert sum(r[col] for r in rows.values()) == got["total"][col], col
    assert got["total"]["kernels"] == 5
    text = spantrace.table(got)
    assert "orb.detect[0]" in text and "outside the program" in text


def test_innermost_marks_where_the_open_span_changes():
    times, ids = spantrace.innermost(SPANS)
    assert times == [0, 10 * US, 20 * US, 200 * US, 500 * US, 600 * US,
                     700 * US, 900 * US, 1000 * US]
    assert ids == [1, 2, 3, 4, 2, 1, 5, 1, None]
    assert spantrace.innermost([]) == ([], [])


def test_spanrun_reads_the_window_by_span_on_the_cpu(small):
    """The loop's spans reach the output: ORB's five sub-stages, the
    matcher and the homography inside each ``frontend.match_pair``, with
    ``orb``'s own time a small part of its total; no slice on the CPU."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = spanrun.main(["--workload", "orb_objrec.cam720p", "--seed",
                           "123456789012", "--seconds", "1.0", "--device",
                           "cpu"], small)
    assert rc == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert got["window_frames"] >= 2 and "slice" not in got
    ms = got["window_ms"]
    assert ms["frontend.match_pair"]["calls"] == 1.0
    assert ms["orb"]["calls"] == 2.0         # the object and the frame
    for st in ("pyramid", "detect", "orient", "describe", "assemble"):
        assert ms[f"orb.{st}"]["self"] > 0, st
    for name in ("match.knn", "match.ratio", "homography"):
        assert ms[name]["calls"] == 1.0, name
    assert ms["orb"]["self"] < 0.2 * ms["orb"]["total"]
    assert set(got["stage_ms"]) >= {"orb", "match", "homography"}
