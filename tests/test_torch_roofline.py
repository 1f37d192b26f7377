"""scripts/roofline_torch.py on the CPU: each row's model (bytes and
operations from its shapes) against the formula it states, the row cache
(rows of another card or power limit dropped), the bound's arithmetic, the
inputs against scripts/roofline.py's draws, the cheap rows' code path, and
that the script raises without a card. No time here is a device number."""
import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _load():
    spec = importlib.util.spec_from_file_location(
        "roofline_torch", os.path.join(_ROOT, "scripts", "roofline_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rf = _load()


@pytest.mark.parametrize("name, model, nbytes, ops", [
    ("fast9", rf.fast9_model(720, 1282, 3000, 1000),
     720 * 1282 + 2000 * 12,
     {"int32": 18 * 720 * 1282 + 40 * 4000 + 720 * 1282}),
    ("hamming", rf.hamming_model(2048, 2048, 256),
     2 * 2048 * 256 + 2 * 2048 * 9,
     {"int8": 2 * 2048 * 2048 * 256, "int32": 2 * 2048 * 2048}),
    ("histogram", rf.histogram_model(923040), 923040 + 1024,
     {"int32": 923040}),
    ("sht", rf.sht_model(65536, 65536, 180, 2942),
     12 * 65536 + 8 * 180 + 4 * 180 * 2942, {"f32": 7 * 65536 * 180}),
    ("ccl", rf.ccl_model(1122 * 1182), 5 * 1122 * 1182,
     {"int32": 10 * 1122 * 1182}),
    ("wolf", rf.wolf_model(923040), 2 * 923040,
     {"int32": 11 * 923040, "f32": 10 * 923040}),
    ("ba_step", rf.ba_model(256, 20000, 100000, 20),
     2 * 4 * (256 * 6 + 20000 * 3) + 16 + 17 * 100000,
     {"f32": 300 * 100000 + 21 * 72 * 100000}),
    ("ba_schur", rf.schur_model(256, 20000, 100000, 600000),
     2 * 4 * (256 * 6 + 20000 * 3) + 16 + 17 * 100000,
     {"f32": 300 * 100000 + 216 * 600000 + 1536 ** 3 // 3
      + 2 * 1536 ** 2}),
])
def test_model_equals_its_formula(name, model, nbytes, ops):
    assert model[0] == nbytes
    assert model[1] == ops
    assert isinstance(model[2], str) and model[2]


def test_bound_takes_the_larger_and_names_it():
    peaks = rf.PEAKS[H100]
    by_bytes = rf.bound(3.35e9, {"int32": 1.0}, peaks)
    assert by_bytes == {"bound_ms": pytest.approx(1.0),
                        "bound_by": "bytes"}
    by_ops = rf.bound(1.0, {"f32": 67e9, "int8": 1979e9}, peaks)
    assert by_ops["bound_by"] == "operations"
    assert by_ops["bound_ms"] == pytest.approx(2.0)
    assert peaks["int32"] == peaks["f32"] / 4


def test_cache_drops_rows_of_another_card_or_power_limit(tmp_path):
    path = str(tmp_path / "rows.json")
    row = {"name": rf.ROWS[2], "ms": 1.0}
    with open(path, "w") as fh:
        json.dump({
            rf.ROWS[0]: {"name": rf.ROWS[0], "device": H100,
                         "power_limit_w": 700.0},
            rf.ROWS[1]: {"name": rf.ROWS[1], "device": H100,
                         "power_limit_w": 500.0},
            rf.ROWS[3]: {"name": rf.ROWS[3], "device": "NVIDIA A100",
                         "power_limit_w": 700.0},
            rf.ROWS[2]: {"name": rf.ROWS[2], "device": H100,
                         "power_limit_w": 700.0, "ms": 9.0}}, fh)
    rows = rf.merge(path, [row], H100, 700.0)
    assert [r["name"] for r in rows] == [rf.ROWS[0], rf.ROWS[2]]
    assert rows[1] == {**row, "device": H100, "power_limit_w": 700.0}
    with open(path) as fh:
        assert sorted(json.load(fh)) == sorted([rf.ROWS[0], rf.ROWS[2]])
    # a run at another limit keeps only its own rows
    assert [r["name"] for r in rf.merge(path, [row], H100, 500.0)] == [
        rf.ROWS[2]]


def test_power_limit_and_table_header():
    assert rf.power_limit_w("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    row = {"name": rf.ROWS[2], "ms": 0.01, "event_ms": 0.009, "bytes": 10,
           "ops": {"int32": 5}, "bound_ms": 0.001, "bound_by": "bytes",
           "share": 0.1, "launches": {}, "model": "m"}
    full = rf.table([row], "NVIDIA H100 80GB HBM3, 700.00 W", rf.PEAKS[H100])
    low = rf.table([row], "NVIDIA H100 80GB HBM3, 500.00 W", rf.PEAKS[H100])
    assert "under 700 W" not in "\n".join(full)
    assert "not scaled" in "\n".join(low) and "under 700 W" in "\n".join(low)
    assert full[-1].startswith(f"| {rf.ROWS[2]} | 0.01 | 0.009 | 10 |")


def test_inputs_are_roofline_py_draws():
    """The draws of scripts/roofline.py's full run, in its order: every
    rs.* call of its main(), read with ast, against roofline_inputs()."""
    with open(os.path.join(_ROOT, "scripts", "roofline.py")) as fh:
        tree = ast.parse(fh.read())
    calls = [n.func.attr for n in sorted(
        (n for n in ast.walk(tree) if isinstance(n, ast.Call)
         and isinstance(n.func, ast.Attribute)
         and isinstance(n.func.value, ast.Name) and n.func.value.id == "rs"),
        key=lambda n: (n.lineno, n.col_offset))]
    assert calls == ["integers", "integers", "integers", "integers",
                     "normal", "normal", "integers", "integers", "normal"]
    inp = rf.roofline_inputs()
    rs = np.random.default_rng(0)
    h, w = inp["gray"].shape
    assert np.array_equal(inp["q"], rs.integers(0, 2, (2048, 256), np.uint8))
    assert np.array_equal(inp["t"], rs.integers(0, 2, (2048, 256), np.uint8))
    assert np.array_equal(inp["x"], rs.integers(0, w, 65536).astype(
        np.float32))
    assert np.array_equal(inp["y"], rs.integers(0, h, 65536).astype(
        np.float32))
    assert inp["cams"].shape == (256, 6) and inp["lms"].shape == (20000, 3)
    assert inp["ci"].max() < 256 and inp["li"].max() < 20000
    assert inp["uv"].shape == (100000, 2)


def test_cheap_rows_run_their_path():
    """The histogram and Wolf rows through measure() on the CPU (the path
    only: this time is not a device number)."""
    rows = rf.measure(["histogram", "wolf"], torch.device("cpu"),
                      rf.PEAKS[H100], 0.01)
    assert [r["name"] for r in rows] == [rf.ROWS[2], rf.ROWS[5]]
    n = 720 * 1282
    assert rows[0]["bytes"] == n + 1024 and rows[0]["ops"] == {"int32": n}
    for r in rows:
        assert r["launches"] == {} and r["event_ms"] is None
        assert r["share"] == pytest.approx(r["bound_ms"] / r["ms"])


def test_without_a_card_it_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        rf.main([])
