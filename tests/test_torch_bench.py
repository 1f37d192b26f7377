"""bench_torch.py, the port's counterpart of bench.py, on the CPU.

* Its copies equal the originals: ``_images()`` bit for bit, and the row
  names, their order and each reference frames/s (the two derived
  baselines too) as bench.py's source states them, read with ``ast``.
* Each of the 29 row functions gives the same (accumulator, checksum) as
  bench.py's own expression for that row, taken from its source with
  ``ast`` and run through ``compv_tpu`` on the CPU, on crops of the same
  inputs (240x320 of the scene, 300x280 of the text scan; the descriptor
  matrices and the 1285x1285 binary whole). The JAX side is called
  eagerly, as the package's own tests call these functions; bench.py runs
  each row inside one jit, where XLA's rewrites move 7 and 4 of the
  crop's 635,208 pixels of ``scale_bilinear`` and ``scale_bicubic`` (the
  port equals the eager reference in every pixel).
  Tolerances: checksums exactly; accumulators exactly, but the float
  sums of ``hog_8x8_l2hys`` (2e-6 on these crops) and
  ``frontend_pair_720p`` (the homography's entries, 1.6e-6) within 1e-5
  relative: sums in another order.
* The harness: ``--device cpu`` lines name the CPU, without it and
  without a card main() raises, a row that raises makes the exit code 1.
"""
import ast
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC_REL = {"hog_8x8_l2hys": 1e-5, "frontend_pair_720p": 1e-5}
NAMES = [name for name, _ in bench_torch.REF_FPS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes on a few cores: one PyTorch
    thread per process for this file, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bench_main():
    """bench.py's main() as an ast node, and its source."""
    with open(os.path.join(_ROOT, "bench.py")) as fh:
        src = fh.read()
    tree = ast.parse(src)
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main"), src


def _assigned(main, name):
    return next(n for n in main.body if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name)


@pytest.fixture(scope="module")
def scenes():
    return bench_torch._images()


def test_images_equal_bench(scenes):
    gray, text = bench._images()
    assert scenes[0].dtype == gray.dtype and scenes[1].dtype == text.dtype
    assert np.array_equal(scenes[0], gray)
    assert np.array_equal(scenes[1], text)
    assert bench_torch.HEADLINE == bench.HEADLINE


def test_rows_and_reference_fps_equal_bench():
    main, src = _bench_main()
    ns = {}
    for name in ("bf_big_ref_fps", "frontend_ref_fps"):
        ns[name] = eval(ast.get_source_segment(src, _assigned(main, name)
                                               .value), {}, ns)
    assert bench_torch.bf_big_ref_fps == ns["bf_big_ref_fps"]
    assert bench_torch.frontend_ref_fps == ns["frontend_ref_fps"]
    cases = _assigned(main, "cases").value.elts
    names = [c.elts[0].value if isinstance(c.elts[0], ast.Constant)
             else {"HEADLINE": bench.HEADLINE}[c.elts[0].id] for c in cases]
    refs = [eval(ast.get_source_segment(src, c.elts[3]), {}, ns)
            for c in cases]
    assert len(names) == 29
    assert list(bench_torch.REF_FPS) == list(zip(names, refs))


@pytest.fixture(scope="module")
def crops(scenes):
    gray, text = scenes
    return bench_torch.inputs(np.ascontiguousarray(gray[100:340, 250:570]),
                              np.ascontiguousarray(text[:300, :280]))


@pytest.fixture(scope="module")
def reference_rows(crops):
    """bench.py's cases list, evaluated from its source in a namespace of
    its own imports and helpers (run as it imports them) and the crops."""
    main, src = _bench_main()
    keep = [n for n in main.body
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef)
                and n.name in ("u8sum", "fsum", "match_sum", "lines_sum",
                               "frontend_pair"))
            or (isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                         ast.Name)
                and n.targets[0].id in ("bf_big_ref_fps", "frontend_ref_fps",
                                        "se3", "cases"))]
    h, w = crops["gray"].shape
    ns = {"jax": jax, "jnp": jnp, "np": np, "HEADLINE": bench.HEADLINE,
          "h": h, "w": w, **{k: jnp.asarray(v) for k, v in crops.items()}}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "bench.py", "exec"),
         ns)
    return {name: (arr, fn) for name, arr, fn, _ in ns["cases"]}


@pytest.fixture(scope="module")
def port_rows(crops):
    return bench_torch.rows({k: torch.from_numpy(v)
                             for k, v in crops.items()})


def test_port_rows_in_bench_order(port_rows):
    assert [r[0] for r in port_rows] == NAMES
    assert [r[3] for r in port_rows] == [ref for _, ref in bench_torch.REF_FPS]


@pytest.mark.parametrize("name", NAMES)
def test_row_equals_reference(name, reference_rows, port_rows):
    arr, fn = reference_rows[name]
    want_acc, want_sum = fn(arr)
    _, parr, pfn, _ = port_rows[NAMES.index(name)]
    got_acc, got_sum = pfn(parr() if callable(parr) else parr)
    assert int(got_sum) == int(want_sum)
    want_acc, got_acc = float(want_acc), float(got_acc)
    rel = ACC_REL.get(name, 0.0)
    assert abs(got_acc - want_acc) <= rel * abs(want_acc), (got_acc,
                                                            want_acc)


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench_torch.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def test_cpu_run_lines_name_the_cpu():
    rc, lines = _run(["--device", "cpu", "--metrics",
                      "rgb24_to_gray,histogram_256,"
                      "fast9_nms_detect_fps_1282x720"])
    assert rc == 0
    assert [line["metric"] for line in lines] == [
        "rgb24_to_gray", "histogram_256", "fast9_nms_detect_fps_1282x720",
        "suite_geomean_vs_reference"]
    for line in lines[:-1]:
        assert line["device"] == "cpu" and line["unit"] == "frames/s"
        assert line["value"] > 0 and line["r1"] == 1 and line["r2"] == 3
        assert line["event_ms"] is None and line["launches"] == {}
    assert lines[1]["checksum"] == 720 * 1282
    assert lines[-1]["device"] == "cpu" and lines[-1]["n_metrics"] == 3
    assert "headline_vs_baseline" in lines[-1]


def test_once_gives_one_call_a_row():
    rc, lines = _run(["--device", "cpu", "--once", "--metrics",
                      "histogram_256"])
    assert rc == 0
    assert lines == [{"metric": "histogram_256", "device": "cpu",
                      "launches": {}, "acc": 923040.0,
                      "checksum": 720 * 1282}]


def test_without_a_card_it_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        bench_torch.main([])


def test_failing_row_fails_the_run(monkeypatch):
    from compv_tpu_torch.image import color

    def broken(rgb):
        raise ValueError("broken on purpose")
    monkeypatch.setattr(color, "rgb_to_gray", broken)
    rc, lines = _run(["--device", "cpu", "--metrics",
                      "rgb24_to_gray,histogram_256"])
    assert rc == 1
    assert lines[0] == {"metric": "rgb24_to_gray",
                        "error": "broken on purpose", "device": "cpu"}
    assert lines[1]["metric"] == "histogram_256" and "error" not in lines[1]
    assert lines[-1]["n_metrics"] == 1


def test_unknown_metric_is_refused():
    with pytest.raises(ValueError, match="no such rows"):
        bench_torch.main(["--device", "cpu", "--metrics", "nope"])
