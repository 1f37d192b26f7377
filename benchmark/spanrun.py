"""A cell's run read by the program's own spans, for the engineer who has
to find where a frame's time goes; the benchmark's result line reads none
of it.

    python3 benchmark/spanrun.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the cell's CUDA device (``--device cpu``
runs the window alone). As a traced run of ``run.py`` does: set-up and
warm-up, then a closed loop of ``--seconds`` with the benchmark's
CUDA-event stage timers, then a profiler slice of the cell's
``slice_requests``. Here the program's span store is on in the loop and
in the slice. Prints to stderr the loop's spans by name (ms a frame,
total / self) and the slice laid against its spans
(``spantrace.reduce_by_span``), and as its last line one JSON object:
the loop's spans and stage times a frame, the slice's totals and by-span
rows.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/spanrun.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from benchmark import devtrace, harness, spantrace
    from benchmark.probe import Probe
    import torch
    from compv_tpu_torch.profiling import (hand_kernel_launches, spans,
                                           span_totals)

    cell = harness.Cell(root, args.workload)
    cuda = args.device == "cuda"
    torch.set_num_threads(1)
    system = cell.system(args.seed, args.device)
    probe = Probe(cell.config["spans"], [], timing=True, device=args.device)
    probe.install()
    out = {}
    try:
        system.setup()
        if cuda:
            torch.cuda.synchronize()
        probe.marks.clear()
        spans.enable()
        loop = harness.closed_loop(system, probe, args.seconds, [False])
        window = spans.take()
        spans.disable()
        if cuda:
            torch.cuda.synchronize()
        frames = sum(r[2] for r in loop["requests"] if r[3])
        print("window spans, ms a frame (total / self): "
              + spantrace.window_line(window, frames), file=sys.stderr)
        out["window_frames"] = frames
        out["window_ms"] = {
            name: {"calls": t["calls"] / frames,
                   "total": t["total_ns"] / 1e6 / frames,
                   "self": t["self_ns"] / 1e6 / frames}
            for name, t in span_totals(window).items()}
        out["stage_ms"] = {stage: ms / frames
                           for stage, ms in probe.stage_ms().items()}
        if cuda:
            n = cell.config["slice_requests"]
            base = len(loop["requests"])
            spans.enable()
            raw = devtrace.run_slice(lambda j: system.serve(base + j), n,
                                     probe, hand_kernel_launches)
            records = spans.take()
            spans.disable()
            nf = n * system.frames_per_request
            slice_ = devtrace.reduce_slice(raw, nf)
            by_span = spantrace.reduce_by_span(raw, records, nf)
            del raw
            print(f"slice by span, totals {by_span['total']}:\n"
                  + spantrace.table(by_span), file=sys.stderr)
            out["slice"] = {"frames": nf, "kernels": slice_["kernels"],
                            "busy_s": slice_["busy_s"],
                            "window_s": slice_["window_s"],
                            "by_span": by_span}
    finally:
        probe.uninstall()
        spans.disable()
    system.release()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_ROOT))
    sys.exit(main(sys.argv[1:], _ROOT))
