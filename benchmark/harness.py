"""The benchmark's machinery, frozen: cell lookup by name, set-up timing,
the closed loop, the traced run's spans and profiler slice, the output
check's verdict, the import guard and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own found by its name: ``configs/<config>.json`` (the
program's settings, the system module that drives it, its spans, captures
and check limits), ``traffic/<mix>.json`` (the parameters of one mix,
with the ``kind`` of its generator), ``generators/<kind>.py`` (a
``make(params, seed, device)`` that builds a mix's inputs),
``systems/<system>.py`` (the entry, how it is served and its comparison
with ``reference/``) and ``metrics/<metric>.py`` (a ``read(m)`` that
returns a number, or None where there is nothing to read).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "compv_tpu")


def process_start_time() -> float:
    """The process's start on the ``time.time()`` clock (Linux /proc;
    10 ms ticks), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix,
    system module and metric readers, all found by name under ``root``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        base = self.root / "benchmark"
        self.config = json.loads(
            (base / "configs" / f"{self.workload['config']}.json").read_text())
        self.traffic = json.loads(
            (base / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.system_path = base / "systems" / f"{self.config['system']}.py"
        self.generator_path = base / "generators" / f"{self.traffic['kind']}.py"
        self.metrics_dir = base / "metrics"

    def _applies(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves") in reported if "moves" in metric else True

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._applies(m, set())]

    def per_layer(self) -> list:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._applies(m, reported)]

    def system(self, seed: int, device):
        """The cell's system, its inputs made by the mix's generator."""
        sysmod = load_module(self.system_path,
                             f"bench_system_{self.config['system']}")
        make = load_module(self.generator_path,
                           f"bench_generator_{self.traffic['kind']}").make
        return sysmod.System(self.config, self.traffic, make, seed, device)

    def reader(self, metric: str):
        return load_module(self.metrics_dir / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}").read


def sample_mask(seed: int, share: float, forced_below: int,
                n: int = 1 << 17):
    """Which requests the output check compares: each with probability
    ``share``, and one below ``forced_below`` always, all from the seed."""
    import numpy as np
    rng = np.random.default_rng([int(seed), 3])
    mask = rng.random(n) < share
    mask[int(rng.integers(0, forced_below))] = True
    return mask


def closed_loop(system, probe, seconds: float, sample) -> dict:
    """One caller: each request starts when the previous one has ended;
    requests start until ``seconds`` have passed and run to their end."""
    reqs, captured, failed = [], {}, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        start = time.perf_counter()
        if start >= deadline:
            break
        recs = [] if sample[i % len(sample)] else None
        ok = True
        with probe.request(recs):
            try:
                result = system.serve(i)
            except Exception:        # a request that raises has failed
                traceback.print_exc(file=sys.stderr)
                ok, result = False, None
                failed += 1
        end = time.perf_counter()
        if recs is not None and ok:
            captured[i] = (recs, result)
        reqs.append((start, end, system.frames_per_request, ok))
        i += 1
    return {"t0": t0, "requests": reqs, "captured": captured,
            "failed": failed}


def verdict(numbers: list) -> bool:
    return bool(numbers) and all(
        n["value"] is not None and n["value"] <= n["limit"] for n in numbers)


def main(argv, root: Path, device: str | None = None) -> int:
    """Run the cell; ``device`` other than None skips the look for a card
    (tests drive the rest of a run on the CPU through it)."""
    t_proc = process_start_time()
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(root, args.workload)
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(Path(root) / "build" / "benchmark" / "nv"))
    import torch

    if device is None:
        need = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"{args.workload} needs {need} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    torch.set_num_threads(1)

    from benchmark.probe import Probe
    from benchmark import devtrace, roofline
    from compv_tpu_torch.profiling import hand_kernel_launches

    system = cell.system(args.seed, device)
    probe = Probe(cell.config["spans"], system.capture, timing=bool(args.trace),
                  modelled=tuple(cell.config.get("models", {})), device=device)
    probe.install()
    try:
        system.setup()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_proc
        probe.marks.clear()         # the warm-up's spans are set-up
        check = cell.config["check"]
        sample = sample_mask(args.seed, check["sample_share"],
                             check["forced_below"])
        loop = closed_loop(system, probe, args.seconds, sample)
        if device != "cpu":
            torch.cuda.synchronize()
            peak = max(torch.cuda.max_memory_allocated(d)
                       for d in range(torch.cuda.device_count()))
        else:
            peak = 0
        stage_ms = probe.stage_ms() if args.trace else {}
        slice_ = None
        t_window = time.perf_counter()
        if args.trace and device != "cpu":
            n = cell.config["slice_requests"]
            base = len(loop["requests"])
            raw = devtrace.run_slice(lambda j: system.serve(base + j), n,
                                     probe, hand_kernel_launches)
            t_slice = time.perf_counter()
            slice_ = devtrace.reduce_slice(raw, n * system.frames_per_request)
            del raw
            print(f"slice: {t_slice - t_window:.1f} s to run, "
                  f"{time.perf_counter() - t_slice:.1f} s to read",
                  file=sys.stderr)
    finally:
        probe.uninstall()

    system.release()
    if device != "cpu":
        torch.cuda.empty_cache()
    numbers, check_error = [], None
    t_check = time.perf_counter()
    try:
        numbers = system.check(loop["captured"])
    except Exception:               # the check itself failing is not correct
        check_error = traceback.format_exc()
        print(check_error, file=sys.stderr)

    print(f"check: {len(loop['captured'])} requests compared in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    window_frames = sum(r[2] for r in loop["requests"] if r[3])
    name = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    m = SimpleNamespace(
        setup_s=setup_s, requests=loop["requests"], t0=loop["t0"],
        stage_ms=stage_ms, window_frames=window_frames, slice=slice_,
        peaks=roofline.PEAKS.get(name),
        model_calls=probe.model_args, models=cell.config.get("models", {}),
        roofline=roofline)
    metrics = {}
    wanted = cell.per_layer() if args.trace else cell.end_to_end()
    for spec in wanted:
        value = cell.reader(spec["name"])(m)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": name,
           "count": cell.workload["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": verdict(numbers) and loop["failed"] == 0
              and check_error is None,
              "attempted": len(loop["requests"]), "failed": loop["failed"],
              "metrics": metrics, "device": dev}
    if slice_:
        dev["busy_s"] = slice_["busy_s"]
        dev["window_s"] = slice_["window_s"]
        result["breakdown"] = {"device_ops": slice_["device_ops"],
                               "idle_gaps": slice_["idle_gaps"]}
        print(f"slice: {slice_['kernels']} kernels over {slice_['frames']} "
              f"frames, stage kernels {slice_['by_stage']}", file=sys.stderr)
    result["checks"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                        for n in numbers}
    found = forbidden_modules()     # whatever the run loaded, the check too
    if found:
        print(f"the run loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 4
    for n in numbers:
        print(f"check {n['name']} {n['value']} limit {n['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
