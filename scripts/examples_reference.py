"""The reference's example programs, run with their outputs kept away from
``examples/out/``, and what they print, parsed.

``examples/*.py`` are the JAX package's runnable programs; the port's
counterparts are ``examples_torch/*.py``. This file is three tools:

* ``parse(name, text)``: the numbers a program printed (the same lines come
  from a reference program and from its port), as a dict. It imports
  nothing beyond the standard library, so ``chip_smoke.py`` and the tests
  load this file by path for it.
* ``--run NAME --out DIR [--record FILE] [--max-frames N] [-- ARGS]``: runs
  ``examples/NAME.py`` in this process with JAX on the CPU and the virtual
  8-device mesh that ``examples/common.py`` sets up, its ``out_path``
  patched to write under DIR (the tracked ``examples/out/`` is never
  written). With ``--record``, the results of the program's calls named in
  ``RECORDED`` are written to FILE as JSON, in full precision (what it
  prints is rounded). ``--max-frames`` ends ``live_demo``'s stream after N
  frames, whatever its ``--seconds`` (``cap_frames``): its first frame
  compiles the ORB pipeline, which on a loaded host can outlast a short
  ``--seconds``.
* with no arguments: runs every program but ``live_demo`` (which serves
  until its time is up) through ``--run`` in a subprocess and prints one
  JSON object, ``{name: {"printed": parse(...), "precise": ...}}``, where
  ``precise`` holds the recorded values that the printed lines round: the
  ``EXAMPLES_REF`` constants of ``chip_smoke.py``. From
  the repository root, on a machine with JAX (about a minute and a half):

      python3 scripts/examples_reference.py

``run_port(name, argv, out_dir)`` runs the port's ``examples_torch/NAME.py``
in the calling process instead: its ``main`` returns the results of the
calls that ``RECORDED`` names, by name, a list of each call's result, as
``--record`` keeps them of the reference (``plain`` makes them JSON-able).
It imports torch, never JAX.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = ("edge_lines", "planar_tracking", "object_recognition",
            "camera_calibration", "distributed_sfm", "live_demo")
# program -> the module-level names of its calls whose results --record keeps
RECORDED = {
    "edge_lines": ("hough_sht", "hough_kht"),
    "planar_tracking": ("track_planar_sequence", "ate_rmse"),
    "object_recognition": ("match_pair",),
    "camera_calibration": ("compute_homography_dlt", "find_chessboard_corners",
                           "calibrate_camera"),
    "distributed_sfm": ("sharded_all_pairs_match", "reproj_rmse"),
    "live_demo": (),
}
_NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


def _nums(text: str) -> list:
    return [float(v) for v in re.findall(_NUM, text)]


def _one(pattern: str, text: str) -> str:
    m = re.search(pattern, text, re.S)
    if m is None:
        raise ValueError(f"no line matches {pattern!r} in:\n{text}")
    return m.group(1)


def _bools(text: str) -> list:
    return [v == "True" for v in re.findall(r"True|False", text)]


def _wrote(text: str) -> list:
    return [os.path.basename(p) for p in re.findall(r"^wrote (.+)$", text,
                                                    re.M)]


def parse(name: str, text: str) -> dict:
    """The numbers ``examples/NAME.py`` (or its port) printed in ``text``."""
    if name == "edge_lines":
        sht = [[float(a), float(b), float(c)] for a, b, c in re.findall(
            rf"rho=\s*({_NUM}) theta=\s*({_NUM})deg votes=({_NUM})", text)]
        out = {"canny_pixels": int(_one(r"canny edge pixels: (\d+)", text)),
               "sht_count": int(_one(r"SHT lines: (\d+)", text)),
               "sht": sht,
               "kht_count": int(_one(r"KHT lines: (\d+)", text))}
    elif name == "planar_tracking":
        out = {"tracked": _bools(_one(r"tracked: (\[.*?\])", text)),
               "inliers": [int(v) for v in
                           _nums(_one(r"inliers: (\[.*?\])", text))],
               "ate": float(_one(rf"trajectory ATE: ({_NUM}) px", text))}
    elif name == "object_recognition":
        m = re.search(r"keypoints: (\d+)/(\d+)\s+matches: (\d+)\s+"
                      r"inliers: (\d+)", text)
        if m is None:
            raise ValueError(f"no keypoints line in:\n{text}")
        out = {"kp1": int(m.group(1)), "kp2": int(m.group(2)),
               "matches": int(m.group(3)), "inliers": int(m.group(4)),
               "h": _nums(_one(r"recovered H:\s*(\[\[.*?\]\])", text)),
               "h_true": _nums(_one(r"true H:\s*(\[\[.*?\]\])", text))}
    elif name == "camera_calibration":
        views = re.findall(r"view (\d+): detected=(True|False)", text)
        k = _nums(_one(r"K: (fx=.*?)\s+\(true", text))
        m = re.search(rf"reproj RMS: ({_NUM}) px \(before LM ({_NUM})\)",
                      text)
        if m is None:
            raise ValueError(f"no RMS line in:\n{text}")
        out = {"detected": [d == "True" for _, d in views],
               "fx": k[0], "fy": k[1], "cx": k[2], "cy": k[3],
               "dist": _nums(_one(r"dist: (\[.*?\])", text)),
               "rms": float(m.group(1)), "rms_initial": float(m.group(2))}
    elif name == "distributed_sfm":
        out = {"devices": int(_one(r"mesh: (\d+) devices", text)),
               "sim_row": _nums(_one(r"first row: (\[.*?\])", text)),
               "rmse_before": float(_one(
                   rf"reproj RMSE before BA: ({_NUM}) px", text)),
               "rmse_after": float(_one(
                   rf"reproj RMSE after distributed BA: ({_NUM}) px", text))}
    elif name == "live_demo":
        m = re.search(rf"done: (\d+) frames at ({_NUM}) fps", text)
        if m is None:
            raise ValueError(f"no done line in:\n{text}")
        out = {"port": int(_one(r"http://127\.0\.0\.1:(\d+)/", text)),
               "frames": int(m.group(1)), "fps": float(m.group(2))}
    else:
        raise ValueError(f"no such program: {name!r}")
    out["wrote"] = _wrote(text)
    return out


def plain(v):
    """JSON-able form of a call's result (arrays and tensors as nested
    lists, named tuples as dicts)."""
    import numpy as np

    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return {f: plain(getattr(v, f)) for f in v._fields}
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if hasattr(v, "detach"):                # a tensor, on any device
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


def cap_frames(mod, n: int):
    """Make ``mod``'s ``run_live`` (live_demo's stream loop) stop after
    ``n`` frames and at no time limit; returns the original."""
    real = mod.run_live

    def run_live(camera, process, server, seconds=None, max_frames=None):
        return real(camera, process, server, max_frames=n)
    mod.run_live = run_live
    return real


def run(name: str, out_dir: str, record: str | None, args: list,
        max_frames: int | None = None) -> None:
    """``examples/NAME.py``'s main() here, its files written under
    ``out_dir``, the recorded calls' results to ``record``."""
    import importlib.util

    examples = os.path.join(ROOT, "examples")
    sys.path.insert(0, examples)
    import common  # the reference's: JAX on the CPU, 8 devices

    os.makedirs(out_dir, exist_ok=True)
    common.out_path = lambda n: os.path.join(out_dir, n)
    path = os.path.join(examples, f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = {}

    def recorder(fname, fn):
        def wrapped(*a, **kw):
            res = fn(*a, **kw)
            calls.setdefault(fname, []).append(plain(res))
            return res
        return wrapped

    for fname in RECORDED[name]:
        setattr(mod, fname, recorder(fname, getattr(mod, fname)))
    if max_frames is not None:
        cap_frames(mod, max_frames)
    sys.argv = [path] + list(args)
    mod.main()
    sys.stdout.flush()
    if record:
        with open(record, "w") as f:
            json.dump(calls, f)


def run_subprocess(name: str, out_dir: str, args=(), timeout: float = 240.0,
                   max_frames: int | None = None) -> tuple:
    """(stdout, recorded calls) of ``examples/NAME.py`` run through
    ``--run`` in a new process (JAX on the CPU); raises on a non-zero exit
    or past ``timeout`` seconds."""
    record = os.path.join(out_dir, "recorded.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    cap = [] if max_frames is None else ["--max-frames", str(max_frames)]
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--run", name,
         "--out", out_dir, "--record", record, *cap, "--", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"examples/{name}.py exited {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(record) as f:
        return proc.stdout, json.load(f)


def precise(name: str, calls: dict) -> dict:
    """The full-precision values behind ``name``'s printed numbers, from
    its recorded calls (a reference run's, or the same fields of a port
    run's results)."""
    if name == "planar_tracking":
        hs = calls["track_planar_sequence"][0]["h_to_first"]
        return {"h_to_first": hs, "ate": calls["ate_rmse"][0]}
    if name == "object_recognition":
        return {"h": calls["match_pair"][0]["h"],
                "inliers_by_frame": [c["num_inliers"]
                                     for c in calls["match_pair"][1:]]}
    if name == "camera_calibration":
        res = calls["calibrate_camera"][0]
        return {k: res[k] for k in ("k", "dist", "rms", "rms_initial")}
    if name == "distributed_sfm":
        return {"rmse_before": calls["reproj_rmse"][0],
                "rmse_after": calls["reproj_rmse"][1]}
    return {}


def load_port(name: str):
    """The port's ``examples_torch/NAME.py`` as a module of that name, with
    ``examples_torch/`` on ``sys.path`` (its ``common`` is the port's, and
    ranks that ``distributed_sfm`` spawns import the module by name)."""
    import importlib.util

    d = os.path.join(ROOT, "examples_torch")
    if d not in sys.path:
        sys.path.insert(0, d)
    common = sys.modules.get("common")
    if common is not None and os.path.dirname(
            os.path.abspath(common.__file__)) != d:
        raise RuntimeError(f"a module named common from {common.__file__} "
                           "is loaded, not examples_torch/common.py")
    mod = sys.modules.get(name)
    if mod is None or os.path.dirname(os.path.abspath(mod.__file__)) != d:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(d, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def run_port(name: str, argv, out_dir: str | None = None,
             max_frames: int | None = None) -> tuple:
    """(stdout, result of main) of the port's ``examples_torch/NAME.py``
    called here with ``argv``; its files go under ``out_dir`` when given,
    else where ``examples_torch/common.out_path`` puts them; ``max_frames``
    as ``--max-frames``."""
    mod = load_port(name)
    if hasattr(mod, "out_path"):
        mod.out_path = sys.modules["common"].out_path
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            mod.out_path = lambda n: os.path.join(out_dir, n)
    real = None if max_frames is None else cap_frames(mod, max_frames)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = mod.main(list(argv))
    finally:
        if real is not None:
            mod.run_live = real
    return buf.getvalue(), result


def main(argv) -> int:
    if argv and argv[0] == "--run":
        rest = argv[argv.index("--") + 1:] if "--" in argv else []
        head = argv[:argv.index("--")] if "--" in argv else argv
        record = head[head.index("--record") + 1] \
            if "--record" in head else None
        cap = int(head[head.index("--max-frames") + 1]) \
            if "--max-frames" in head else None
        run(head[1], head[head.index("--out") + 1], record, rest, cap)
        return 0
    ref = {}
    for name in PROGRAMS:
        if name == "live_demo":
            continue
        with tempfile.TemporaryDirectory() as d:
            text, calls = run_subprocess(name, d)
        ref[name] = {"printed": parse(name, text),
                     "precise": precise(name, calls)}
        print(text, file=sys.stderr, end="")
    print(json.dumps(ref))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
