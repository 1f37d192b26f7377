"""The hand kernels' table (``compv_tpu_torch/ops/kernels/_build.py``) held
to the sources, and its one launch path on a fake library.

Each row's ``csrc/`` source defines its counted device kernel as a
``__global__`` function, and each replaced Pallas function is defined at
the line the row names; every entry a wrapper declares is an exported
function of its source, and every launch entry ends with the stream's
handle; no module of the package but ``_build.py`` loads a kernel library.
On a fake library (no card needed): a launch that returns a non-zero
``cudaError`` raises with the entry's name and counts nothing, one that
returns 0 counts exactly one launch of its row, and the stream's handle
is appended to the arguments.
"""
import ast
import contextlib
import ctypes
import importlib
import inspect
import re
import types
from pathlib import Path

import pytest
import torch

from compv_tpu_torch import profiling
from compv_tpu_torch.ops.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "compv_tpu_torch"
# each row's wrapper: the module of its source's name
WRAPPERS = tuple(dict.fromkeys(k.source for k in _build.KERNELS))
ROWS = {k.id: k for k in _build.KERNELS}


def _entries(module_name: str) -> list:
    module = importlib.import_module(
        f"compv_tpu_torch.ops.kernels.{module_name}")
    return [v for v in vars(module).values() if isinstance(v, _build.Entry)]


def test_the_table_has_one_row_a_counted_kernel():
    assert list(ROWS) == ["K1", "K2a", "K2b", "K3", "K4", "K5", "K6", "K7"]
    names = [k.name for k in _build.KERNELS]
    assert len(set(names)) == len(names)
    assert list(_build.launch_counts()) == names
    assert list(_build.launch_counts("id")) == list(ROWS)


@pytest.mark.parametrize("kid", list(ROWS))
def test_row_source_defines_its_counted_kernel(kid):
    row = ROWS[kid]
    source = _build.CSRC / f"{row.source}.cu"
    assert source.exists(), source
    defined = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s*)?(\w+)\s*\(", source.read_text())
    assert row.name in defined, (row.name, defined)


@pytest.mark.parametrize("kid", [k.id for k in _build.KERNELS if k.replaces])
def test_row_names_the_pallas_function_it_replaces(kid):
    path, line = ROWS[kid].replaces.rsplit(":", 1)
    text = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def \w+\(", text), (ROWS[kid].replaces, text)


def test_only_k6_and_k7_replace_no_pallas_function():
    assert [k.id for k in _build.KERNELS if k.replaces is None] == ["K6",
                                                                     "K7"]


@pytest.mark.parametrize("module_name", WRAPPERS)
def test_wrapper_entries_are_exported_by_their_source(module_name):
    entries = _entries(module_name)
    assert entries, module_name
    assert {e.library for e in entries} == {_build.LIBRARIES[module_name]}
    for e in entries:
        text = (_build.CSRC / f"{e.library.source}.cu").read_text()
        exported = text.split('extern "C" {', 1)[1]
        assert re.search(rf"^\w[\w\s*]*\b{e.name}\(", exported,
                         re.MULTILINE), e.name
        if e.counts is not None:
            assert e.counts in _build.launch_counts(), e.name
            assert e.argtypes[-1] is ctypes.c_void_p, e.name  # the stream


def test_every_row_is_launched_by_some_wrapper():
    counted = {e.counts for m in WRAPPERS for e in _entries(m)} - {None}
    assert counted == {k.name for k in _build.KERNELS}


def _calls(path: Path) -> set:
    """What ``path`` calls of ``ctypes.CDLL`` and ``_build.load``."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            owner = node.func.value
            name = owner.id if isinstance(owner, ast.Name) else None
            if node.func.attr == "CDLL":
                found.add("CDLL")
            elif node.func.attr == "load" and name == "_build":
                found.add("_build.load")
        elif isinstance(node, ast.ImportFrom) and (node.module or ""
                                                    ).endswith("_build"):
            if any(a.name == "load" for a in node.names):
                found.add("_build.load")
    return found


def test_only_build_opens_the_hand_kernels():
    """No module of the package but ``_build.py`` calls ``ctypes.CDLL`` or
    ``_build.load``; ``native_rt.py`` loads the g++ host runtime (no hand
    kernel) with ``ctypes.CDLL``."""
    callers = {str(p.relative_to(PACKAGE)): _calls(p)
               for p in sorted(PACKAGE.rglob("*.py"))}
    callers = {p: c for p, c in callers.items() if c}
    assert callers == {"ops/kernels/_build.py": {"CDLL"},
                       "native_rt.py": {"CDLL"}}


def test_hand_kernel_launches_reads_the_table():
    assert profiling.hand_kernel_launches() == _build.launch_counts()
    source = inspect.getsource(profiling.hand_kernel_launches)
    for module_name in WRAPPERS:
        assert module_name not in source


@pytest.fixture
def fake(monkeypatch):
    """A library of one launch entry per row and a query, whose calls are
    recorded and whose launches return ``fake.rc``; the card's device
    context and stream replaced, the counters zeroed for the test."""
    state = types.SimpleNamespace(rc=0, calls=[], loads=0)

    def launch_fn(name):
        def fn(*args):
            state.calls.append((name, args))
            return state.rc
        return fn

    def load(source):
        state.loads += 1
        return types.SimpleNamespace(
            **{f"compv_fake_{k.id}": launch_fn(k.id) for k in _build.KERNELS},
            compv_fake_query=lambda n: 2 * n)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "LIBRARIES", {})
    monkeypatch.setattr(_build, "_COUNTS",
                        dict.fromkeys(_build._COUNTS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    lib = _build.Library("fake")
    state.entries = {k.id: lib.entry(f"compv_fake_{k.id}",
                                     [ctypes.c_int, ctypes.c_void_p],
                                     counts=k.name)
                     for k in _build.KERNELS}
    state.query = lib.entry("compv_fake_query", [ctypes.c_int])
    return state


@pytest.mark.parametrize("kid", list(ROWS))
def test_a_launch_that_returns_0_counts_one(fake, kid):
    fake.entries[kid].launch("cuda:0", 5)
    assert fake.calls == [(kid, (5, 77))]
    assert _build.launch_counts("id") == {k: int(k == kid) for k in ROWS}


@pytest.mark.parametrize("kid", list(ROWS))
def test_a_launch_that_fails_raises_and_counts_nothing(fake, kid):
    fake.rc = 700
    with pytest.raises(RuntimeError,
                       match=rf"^compv_fake_{kid} launch failed: "
                             "cudaError 700$"):
        fake.entries[kid].launch("cuda:0", 5)
    assert set(_build.launch_counts().values()) == {0}


def test_library_loads_once_and_queries_count_nothing(fake):
    assert fake.query(21) == 42
    fake.entries["K1"].launch("cuda:0", 1)
    fake.entries["K1"].launch("cuda:0", 2)
    assert fake.loads == 1
    assert _build.launch_counts()["fast_kernel"] == 2
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}


def test_a_failed_check_leaves_the_library_unloaded(monkeypatch):
    monkeypatch.setattr(_build, "LIBRARIES", {})
    loads = []
    monkeypatch.setattr(_build, "load", lambda source: loads.append(
        source) or types.SimpleNamespace(compv_q=lambda: 3))

    def check():
        raise RuntimeError("source and module disagree")

    entry = _build.Library("fake", check=check).entry("compv_q", [])
    for _ in range(2):
        with pytest.raises(RuntimeError, match="disagree"):
            entry()
        assert entry.fn is None
    assert loads == ["fake", "fake"]


def test_an_entry_counts_only_a_row_of_the_table(monkeypatch):
    monkeypatch.setattr(_build, "LIBRARIES", {})
    with pytest.raises(ValueError, match="no kernel"):
        _build.Library("fake").entry("compv_x", [ctypes.c_void_p],
                                     counts="not_a_kernel")
