"""Readings for the output check's limits: the program's compared numbers
on many seeds, and the control's (the reference in the program's place,
in bfloat16) on a few, at the cell's own sizes.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--requests N]

Each seed builds the cell's inputs as a run does, serves ``--requests``
requests (default: the configuration's ``readings_requests``, as many as
a run compares) with every one captured, and prints one JSON line: every
number the system computes for the program and, for the control seeds,
for the control (the configuration's limits name those compared). Runs
on the card, as the benchmark does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(root: Path, workload: str, seeds, control_seeds, requests,
             device="cuda", out=print):
    import torch
    from benchmark.harness import Cell
    from benchmark.probe import Probe

    cell = Cell(root, workload)
    n_req = requests or cell.config["check"]["readings_requests"]
    for seed in seeds:
        t0 = time.time()
        system = cell.system(seed, device)
        probe = Probe(cell.config["spans"], system.capture, timing=False,
                      device=device)
        probe.install()
        try:
            system.setup()
            captured = {}
            for i in range(n_req):
                recs = []
                with probe.request(recs):
                    result = system.serve(i)
                captured[i] = (recs, result)
        finally:
            probe.uninstall()
        system.check(captured)
        line = {"workload": workload, "seed": seed, "requests": n_req,
                "program": system.seen}
        if seed in control_seeds:
            line["control"] = system.control_readings(captured)
        line["seconds"] = round(time.time() - t0, 1)
        out(json.dumps(line))
        sys.stdout.flush()
        del system, captured
        if device != "cpu":
            torch.cuda.empty_cache()


def main(argv, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--requests", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    readings(root, args.workload, args.seeds, set(args.control_seeds),
             args.requests)
    return 0


if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_ROOT))
    sys.exit(main(sys.argv[1:], _ROOT))
