"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA devices.
Exits non-zero, printing no result, without them.
"""
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    # one process with few threads: the program's host work is one
    # Python thread, and idle pool threads only add noise to its pace
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_ROOT))
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], _ROOT))
