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

The signature case holds parameters too: every parameter of a reference
callable is one of the port's under its name, a positional one at its
place, with a default where the reference has one; the port's own
parameters come after them. ``SIGNATURE_EXCEPTIONS`` lists the callables
that differ on purpose, each with its reason, and a case checks that each
still does.

The reference's modules are imported on the CPU (this suite's conftest
pins JAX there); nothing here imports the reference from the port.
"""
import ast
import importlib
import os

import pytest

from compv_tpu_torch.ops.kernels import _build

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


# (reference module, name) -> why its parameters are not the port's
SIGNATURE_EXCEPTIONS = {
    ("compv_tpu.ops.pallas.hough_kernel", "sht_accumulate_pallas"):
        "K4's wrapper takes the (n_theta,) f32 trig table (cos_t, sin_t) in "
        "place of theta_step, w_img and h_img, from which the Pallas kernel "
        "builds its own: the table's f32 values decide the bins",
    ("compv_tpu.slam.ba", "obs_jacobian_blocks"):
        "onehot_c is the TPU's (O, F) camera one-hot for its MXU "
        "contraction; the port gathers each observation's camera by index",
}


def _signature_problems(ref, port) -> list:
    """How ``port``'s parameters fail to take a call written against
    ``ref``'s (empty: they take every one)."""
    import inspect
    try:
        rs = inspect.signature(ref)
        ps = inspect.signature(port)
    except (TypeError, ValueError):
        return []                   # no readable signature (a builtin)
    want = [p for p in rs.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    got = list(ps.parameters.values())
    var_kw = any(p.kind == p.VAR_KEYWORD for p in got)
    out = []
    for i, p in enumerate(want):
        q = ps.parameters.get(p.name)
        if q is None:
            if not var_kw:
                out.append(f"no parameter {p.name}")
            continue
        if p.kind != p.KEYWORD_ONLY and (
                q.kind == q.KEYWORD_ONLY or i >= len(got)
                or got[i].name != p.name):
            out.append(f"{p.name} is not parameter {i}")
        if p.default is not p.empty and q.default is q.empty:
            out.append(f"{p.name} has no default")
    if any(p.kind == p.VAR_POSITIONAL for p in rs.parameters.values()) and \
            not any(q.kind == q.VAR_POSITIONAL for q in got):
        out.append("no *args")
    return out


def _callables(mod: str):
    """(name, reference object, port object) of each public callable of
    ``mod`` that the port has."""
    ref = importlib.import_module(mod)
    port = importlib.import_module(_port_name(mod))
    for name in _public_names(mod):
        obj = getattr(ref, name, None)
        if not callable(obj) or (mod, name) in EXCEPTIONS:
            continue
        yield name, obj, getattr(port, KERNEL_ENTRIES.get((mod, name), name))


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


@pytest.mark.parametrize("mod", MODULES)
def test_port_takes_the_reference_parameters(mod):
    bad = {}
    for name, ref, port in _callables(mod):
        if (mod, name) in SIGNATURE_EXCEPTIONS:
            continue
        problems = _signature_problems(ref, port)
        if problems:
            bad[name] = problems
    assert not bad, f"{_port_name(mod)}: {bad}"


def test_signature_exceptions_still_differ():
    assert len(SIGNATURE_EXCEPTIONS) <= 2
    for (mod, name), why in SIGNATURE_EXCEPTIONS.items():
        assert why
        found = {n: (r, p) for n, r, p in _callables(mod)}
        assert name in found, (mod, name)
        assert _signature_problems(*found[name]), (
            f"{mod}.{name} now takes the reference's parameters: drop its "
            f"signature exception")


def _defines(where: str, name: str) -> bool:
    """Whether ``file:line`` of the repository starts the definition of
    ``name``."""
    path, line = where.rsplit(":", 1)
    with open(os.path.join(_ROOT, path)) as f:
        text = f.read().splitlines()[int(line) - 1]
    return text.startswith(f"def {name}(")


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
        # the kernel is a row of the hand kernels' table, whose launches
        # are counted on the card: the row that replaces this function
        rows = [k for k in _build.KERNELS if k.replaces
                and _defines(k.replaces, name)]
        assert len(rows) == 1, (mod, name)
        assert rows[0].name in _build.launch_counts(), (mod, name)


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
