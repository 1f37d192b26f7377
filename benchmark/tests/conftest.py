"""Helpers of the benchmark's own tests (run on the CPU:
``python -m pytest benchmark/tests -q``)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_root(dst: Path) -> Path:
    """A copy of the benchmark at sizes a CPU test run holds: the same
    files, with the traffic and capacities made small."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")

    def update(rel, fn):
        path = dst / rel
        data = json.loads(path.read_text())
        fn(data)
        path.write_text(json.dumps(data, indent=1))

    update("benchmark/traffic/cam720p.json",
           lambda t: t.update(height=180, width=320, pool=4, shift_px=16.0))

    def objrec(c):
        c["port_config"]["orb"].update(max_features=300, levels=3)
        c["warmup_requests"] = 1
        c["check"]["readings_requests"] = 2

    update("benchmark/configs/orb_objrec.json", objrec)
    return dst


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
