"""The output check has teeth: the control (the reference in the
program's place, in bfloat16) fails the cell's limits, and a run driven
with its timed path broken underneath comes out not correct, once for
each fault the cell can have (one chip: no exchange between chips)."""
import json

import pytest
import torch

from benchmark import harness
from benchmark.control import readings
from test_bench_harness import run_cell

FRONTEND = "compv_tpu_torch.slam.frontend"


def _limits(root, config):
    cfg = json.loads((root / "benchmark" / "configs" / f"{config}.json")
                     .read_text())
    return cfg["check"]["limits"]


@pytest.mark.parametrize("cell,config", [
    ("orb_objrec.cam720p", "orb_objrec")])
def test_control_fails_and_the_program_passes(small, cell, config):
    lines = []
    readings(small, cell, [2 ** 32 + 9], {2 ** 32 + 9}, 0, device="cpu",
             out=lines.append)
    line = json.loads(lines[0])
    limits = _limits(small, config)
    assert all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line


def _patch(monkeypatch, module, attr, make):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))


def test_an_altered_homography_is_not_correct(small, monkeypatch):
    def make(fn):
        def broken(*a, **k):
            res = fn(*a, **k)
            h = res.h.clone()
            h[0, 2] += 20.0
            return res._replace(h=h)
        return broken
    _patch(monkeypatch, FRONTEND, "find_homography", make)
    assert not run_cell(small, "orb_objrec.cam720p", seed=31)["correct"]


def test_a_stale_answer_is_not_correct(small, monkeypatch):
    def make(fn):
        first = []

        def stale(*a, **k):
            res = fn(*a, **k)
            if not first:
                first.append(res)
            return first[0]
        return stale
    _patch(monkeypatch, FRONTEND, "find_homography", make)
    assert not run_cell(small, "orb_objrec.cam720p", seed=33)["correct"]


def test_half_the_keypoints_left_out_is_not_correct(small, monkeypatch):
    def make(fn):
        def broken(*a, **k):
            res = fn(*a, **k)
            kp = res.keypoints
            valid = kp.valid.clone()
            valid[valid.shape[0] // 2:] = False
            return res._replace(keypoints=kp._replace(valid=valid))
        return broken
    _patch(monkeypatch, FRONTEND, "orb_detect_describe", make)
    assert not run_cell(small, "orb_objrec.cam720p", seed=32)["correct"]


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size():
    """On the card, at each cell's own size: the program passes and the
    control fails (``python -m pytest -p no:cacheprovider -m cuda
    benchmark/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from conftest import ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        lines = []
        readings(ROOT, w["name"], [2 ** 31 + 17], {2 ** 31 + 17}, 1,
                 out=lines.append)
        line = json.loads(lines[0])
        limits = _limits(ROOT, w["config"])
        assert all(line["program"][k] <= v for k, v in limits.items())
        assert any(line["control"][k] > v for k, v in limits.items())
