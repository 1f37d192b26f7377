"""The port's public surface is the reference's.

For every module of ``compv_tpu/`` (``ops/pallas/X`` maps to the port's
``ops/kernels/X``), every name of its ``__all__`` (or, where it has none,
every public top-level definition, and for a package's ``__init__`` every
name it imports from the package) is an attribute of the port's
counterpart module. The Pallas entry points are matched to the port's
wrappers of the same kernels (``KERNEL_ENTRIES``), which launch the CUDA
kernel on the card; ``EXCEPTIONS`` lists what the port leaves out, each
with its reason, and a case checks that each of them is still missing
(an entry whose name the port gained must go). One case per module, and
one that every program of ``examples/`` has its port in
``examples_torch/``.

The reference's modules are imported on the CPU (this suite's conftest
pins JAX there); nothing here imports the reference from the port.
"""
import ast
import importlib
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (reference module, name in it) -> the port's name for the same kernel
KERNEL_ENTRIES = {
    ("compv_tpu.ops.pallas.fast_kernel", "fast_strengths_nms_pallas"):
        "fast_strengths_nms",
    ("compv_tpu.ops.pallas.ccl_kernel", "pallas_label"): "ccl_label",
    ("compv_tpu.ops.pallas.ccl_kernel", "pallas_label_seeded"):
        "ccl_label_seeded",
    ("compv_tpu.ops.pallas.hough_kernel", "sht_accumulate_pallas"):
        "sht_accumulate",
}
# (reference module, name) -> why the port has no counterpart
EXCEPTIONS = {
    ("compv_tpu.ops.pallas.ccl_kernel", "BIG"):
        "the Pallas labeler's internal sentinel (the padding of its seed "
        "map in VMEM, and its size limit h * w < 2^30); both labelers "
        "return background as -1, and the port's keeps its sentinels "
        "private",
}


def _modules():
    out = []
    base = os.path.join(_ROOT, "compv_tpu")
    for d, _, names in os.walk(base):
        for n in sorted(names):
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, n), _ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


MODULES = _modules()


def _port_name(mod: str) -> str:
    port = "compv_tpu_torch" + mod[len("compv_tpu"):]
    return port.replace("compv_tpu_torch.ops.pallas",
                        "compv_tpu_torch.ops.kernels")


def _public_names(mod: str) -> list:
    ref = importlib.import_module(mod)
    if hasattr(ref, "__all__"):
        return list(ref.__all__)
    path = ref.__file__
    tree = ast.parse(open(path).read(), filename=path)
    is_pkg = os.path.basename(path) == "__init__.py"
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif is_pkg and isinstance(node, ast.ImportFrom) and \
                (node.level > 0 or (node.module or "").startswith(mod)):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


def test_every_reference_module_is_walked():
    assert len(MODULES) > 70
    for mod in ("compv_tpu", "compv_tpu.parallel.sharded",
                "compv_tpu.ops.pallas.fast_kernel", "compv_tpu.viz.stream",
                "compv_tpu.slam.ba_schur", "compv_tpu.core"):
        assert mod in MODULES, mod


@pytest.mark.parametrize("mod", MODULES)
def test_port_module_has_the_reference_names(mod):
    port = importlib.import_module(_port_name(mod))
    missing = []
    for name in _public_names(mod):
        if (mod, name) in EXCEPTIONS:
            continue
        if not hasattr(port, KERNEL_ENTRIES.get((mod, name), name)):
            missing.append(name)
    assert not missing, f"{_port_name(mod)} lacks {missing}"


def test_exceptions_and_kernel_entries_are_current():
    assert len(EXCEPTIONS) <= 3
    for (mod, name), why in EXCEPTIONS.items():
        assert why
        assert name in _public_names(mod), (mod, name)
        assert not hasattr(importlib.import_module(_port_name(mod)), name), (
            f"{_port_name(mod)} now has {name}: drop its exception")
    for (mod, name), port_name in KERNEL_ENTRIES.items():
        assert name in _public_names(mod), (mod, name)
        port = importlib.import_module(_port_name(mod))
        wrapper = getattr(port, port_name)
        assert callable(wrapper), (mod, port_name)
        # the wrapper counts its kernel's launches on the card (K1's count
        # is its module's, shared by its two entries)
        count = getattr(wrapper, "launches", getattr(port, "launches", None))
        assert isinstance(count, int), (mod, port_name)


def test_every_example_program_has_its_port():
    ref = sorted(n for n in os.listdir(os.path.join(_ROOT, "examples"))
                 if n.endswith(".py"))
    port = sorted(n for n in os.listdir(os.path.join(_ROOT, "examples_torch"))
                  if n.endswith(".py"))
    assert len(ref) == 7 and "common.py" in ref
    assert port == ref
    for name in ref:
        if name == "common.py":
            continue
        src = open(os.path.join(_ROOT, "examples_torch", name)).read()
        tree = ast.parse(src)
        mains = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "main"]
        assert len(mains) == 1, name
        assert [a.arg for a in mains[0].args.args] == ["argv"], name
        assert mains[0].args.defaults and isinstance(
            mains[0].args.defaults[0], ast.Constant), name
        assert "add_device_arg(ap)" in src, name
