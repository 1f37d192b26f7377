"""The harness finds everything by name, keeps to the contract's shapes,
repeats its inputs for a seed, and loads nothing of JAX."""
import ast
import io
import json
import re
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_cell(root, cell, seed=123456789012, seconds=1.0, trace=0):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = harness.main(["--workload", cell, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          root, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_contract_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_find_their_files_by_name(small):
    b = json.loads((small / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = harness.Cell(small, w["name"])
        assert cell.system_path.is_file() and cell.generator_path.is_file()
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer()
        for m in cell.end_to_end() + cell.per_layer():
            assert callable(cell.reader(m["name"]))
    for m in b["end_to_end"] + b["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
        assert (small / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


# A generator of another kind, as a later PR would add it: the object
# shifted by whole pixels, with no resampling and no noise.
SHIFTED = """
import numpy as np
import torch

from benchmark import scenes


def make(p, seed, device):
    h, w = p["height"], p["width"]
    rng = np.random.default_rng([int(seed), 7])
    gen = scenes.device_generator(rng.integers(1 << 62), device)
    obj = scenes.object_scene(h, w, int(rng.integers(1 << 62)), gen, device)
    frames, hs = [], []
    for _ in range(p["pool"]):
        dx, dy = (int(v) for v in rng.integers(-p["shift_px"], p["shift_px"] + 1, 2))
        frames.append(torch.roll(obj, (dy, dx), (0, 1)))
        hs.append(np.array([[1.0, 0, dx], [0, 1.0, dy], [0, 0, 1.0]]))
    return obj, torch.stack(frames), np.stack(hs)
"""


def _add_cell(root, name, mix):
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": name, "config": "orb_objrec",
                           "traffic": mix, "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "orb_objrec.cam720p" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))


@pytest.mark.parametrize("mix,kind", [("tiny", "warped_stream"),
                                      ("shifted", "shifted_copies")])
def test_a_dropped_mix_is_found_with_no_code_edit(small, tmp_path, mix, kind):
    import shutil
    root = tmp_path / "root"
    shutil.copytree(small, root)
    params = {"kind": kind, "height": 120, "width": 200, "pool": 2,
              "shift_px": 4.0}
    if kind == "warped_stream":
        params.update(rotation_deg=5.0, scale_min=0.95, scale_max=1.05,
                      noise_sigma=2.0, fill=96.0)
    else:
        (root / "benchmark" / "generators" / f"{kind}.py").write_text(SHIFTED)
    (root / "benchmark" / "traffic" / f"{mix}.json").write_text(
        json.dumps(params))
    _add_cell(root, f"orb_objrec.{mix}", mix)
    res = run_cell(root, f"orb_objrec.{mix}", trace=1)
    assert res["correct"] and res["attempted"] >= 1
    assert {"orb_ms_per_frame.objrec", "frame_ms_p95.objrec"} <= set(
        res["metrics"])
    assert list(res)[-1] == "checks"
    res = run_cell(root, f"orb_objrec.{mix}", trace=0)
    assert {"frames_per_s", "setup_s"} == set(res["metrics"])


def test_unknown_cell_and_missing_card_print_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "orb_objrec.cam720p", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    with pytest.raises(KeyError):
        harness.Cell(ROOT, "no_such.cell")


def test_inputs_repeat_for_a_seed():
    p = {"height": 96, "width": 160, "pool": 3, "rotation_deg": 15.0,
         "scale_min": 0.85, "scale_max": 1.15, "shift_px": 8.0,
         "noise_sigma": 2.0, "fill": 96.0}
    make = harness.load_module(
        ROOT / "benchmark" / "generators" / "warped_stream.py", "gen_ws").make
    a = make(p, 2 ** 33 + 5, "cpu")
    b = make(p, 2 ** 33 + 5, "cpu")
    c = make(p, 2 ** 33 + 6, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert np.array_equal(a[2], b[2])
    assert not torch.equal(a[1], c[1])
    m1 = harness.sample_mask(99, 0.25, 4)
    assert np.array_equal(m1, harness.sample_mask(99, 0.25, 4)) and m1[:4].any()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"compv_tpu_torch", "compv_tpu", "jax", "jaxlib",
                           "flax"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.orb, benchmark.reference.geometry, "
            "benchmark.reference.matcher; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'compv_tpu_torch', 'compv_tpu', 'jax'}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax(small):
    code = "\n".join([
        "import sys, io, contextlib",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from benchmark import harness",
        "with contextlib.redirect_stdout(io.StringIO()):",
        "    rc = harness.main(['--workload', 'orb_objrec.cam720p', '--seed',"
        f" '5', '--seconds', '0.5'], {str(small)!r}, device='cpu')",
        "print(rc, harness.forbidden_modules())"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stderr[-2000:]
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "compv_tpu")
    sys.modules["compv_tpu_fake_check"] = sys  # a prefix is not a match
    try:
        assert "compv_tpu_fake_check" not in harness.forbidden_modules()
    finally:
        del sys.modules["compv_tpu_fake_check"]


def test_jax_loaded_by_the_check_prints_no_result(small, monkeypatch):
    """The guard looks once everything has run, the reference's check and
    the metric readers too: a JAX module loaded by any of them means no
    result line."""
    real = harness.load_module

    def load(path, name):
        mod = real(path, name)
        if name.startswith("bench_system_"):
            check = mod.System.check

            def check_loading_jax(self, captured):
                monkeypatch.setitem(sys.modules, "jax",
                                    types.ModuleType("jax"))
                return check(self, captured)
            monkeypatch.setattr(mod.System, "check", check_loading_jax)
        return mod
    monkeypatch.setattr(harness, "load_module", load)
    out, err = io.StringIO(), io.StringIO()
    from contextlib import redirect_stderr
    with redirect_stdout(out), redirect_stderr(err):
        rc = harness.main(["--workload", "orb_objrec.cam720p", "--seed",
                           "41", "--seconds", "0.5"], small, device="cpu")
    assert rc != 0 and out.getvalue().strip() == ""
    assert "['jax']" in err.getvalue()


def test_metric_readers():
    from types import SimpleNamespace
    cell = harness.Cell(ROOT, "orb_objrec.cam720p")
    reqs = [(0.0, 0.1, 1, True), (0.1, 0.3, 1, True), (0.3, 0.35, 1, True)]
    m = SimpleNamespace(requests=reqs, t0=0.0, setup_s=4.0,
                        stage_ms={"orb": 30.0}, window_frames=3, slice=None)
    assert cell.reader("frames_per_s")(m) == pytest.approx(3 / 0.35)
    assert cell.reader("frame_ms_p95.objrec")(m) == pytest.approx(200.0)
    assert cell.reader("orb_ms_per_frame.objrec")(m) == pytest.approx(10.0)
    assert cell.reader("homography_ms_per_frame")(m) is None
    assert cell.reader("device_idle_pct.objrec")(m) is None
    m.slice = {"busy_s": 0.25, "window_s": 1.0, "kernels": 900, "frames": 3,
               "by_stage": {}}
    assert cell.reader("device_idle_pct.objrec")(m) == pytest.approx(75.0)
    assert cell.reader("launches_per_frame.objrec")(m) == 300
    m.peaks, m.model_calls = None, {}
    assert cell.reader("fast_roofline_pct.objrec")(m) is None
