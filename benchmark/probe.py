"""The benchmark's own instruments around the program: wrappers on the
module attributes that the entry calls.

Each wrapped attribute belongs to a stage (its span) and may be captured
(its arguments and result kept for the output check). A stage is timed by
CUDA events around its outermost call (a call of a stage inside a call of
the same stage is not counted twice), summed over the window, in the
traced run only: the pattern of ``chip_smoke.py``'s ``stage_timer``. During
the profiler slice each stage's call is also a ``record_function`` range
named ``bench.<stage>``, and the arguments of the stages that have a
roofline model are kept, to compute the work of each call afterwards.
Outside the traced run the wrappers only capture, for the requests the
sample names, which costs a Python call.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch


def snapshot(value):
    """``value`` with its host tensors and arrays copied: a caller may
    reuse a host buffer after the call (on the card the program copies
    its inputs to the device, on the CPU a tensor can alias a numpy
    buffer that the next frame overwrites). Device tensors are kept as
    they are."""
    if isinstance(value, torch.Tensor):
        return value.clone() if value.device.type == "cpu" else value
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, tuple):
        items = [snapshot(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value


def _resolve(target: str):
    module, attr = target.split(":")
    return importlib.import_module(module), attr


class Probe:
    def __init__(self, spans: dict, capture: list, timing: bool,
                 modelled: tuple = (), device="cuda"):
        self.stage_of = {t: stage for stage, ts in spans.items() for t in ts}
        self.capture = set(capture)
        self.timing = timing
        self.modelled = set(modelled)
        self.cuda = torch.device(device).type == "cuda"
        self.depth = {stage: 0 for stage in spans}
        self.marks = []             # (stage, start, end) of the window
        self.records = None         # the captured calls of this request
        self.slicing = False
        self.model_args = {}        # stage -> [args] in the slice
        self._saved = []

    def install(self):
        for target in sorted(set(self.stage_of) | self.capture):
            module, attr = _resolve(target)
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))
            setattr(module, attr, self._wrap(target, fn))

    def uninstall(self):
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved.clear()

    def _stamp(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _wrap(self, target, fn):
        stage = self.stage_of.get(target)
        captured = target in self.capture
        name = target.split(":")[1]

        def call(*args, **kwargs):
            outer = stage is not None and self.depth[stage] == 0
            timed = outer and self.timing and not self.slicing
            ranged = outer and self.slicing
            rec = None
            if captured and self.records is not None:
                rec = {"fn": name, "args": snapshot(args),
                       "kwargs": kwargs}
                self.records.append(rec)
            if ranged and stage in self.modelled:
                self.model_args.setdefault(stage, []).append(args)
            if stage is not None:
                self.depth[stage] += 1
            rf = (torch.autograd.profiler.record_function(f"bench.{stage}")
                  if ranged else contextlib.nullcontext())
            start = self._stamp() if timed else None
            try:
                with rf:
                    out = fn(*args, **kwargs)
            finally:
                if stage is not None:
                    self.depth[stage] -= 1
                if timed:
                    self.marks.append((stage, start, self._stamp()))
            if rec is not None:
                rec["out"] = out
            return out

        return call

    @contextlib.contextmanager
    def request(self, records):
        """Capture the wrapped calls of one request into ``records`` (a
        list), or nothing when it is None."""
        self.records = records
        try:
            yield
        finally:
            self.records = None

    def stage_ms(self) -> dict:
        """Total ms by stage over the window (after the device is idle)."""
        out = {}
        for stage, start, end in self.marks:
            ms = (start.elapsed_time(end) if self.cuda
                  else (end - start) * 1e3)
            out[stage] = out.get(stage, 0.0) + ms
        return out
