"""The reference side of the differential sweep: run a case of
``tests/test_torch_parity_cases.py`` through ``compv_tpu`` on the CPU (the
suite's conftest pins JAX there) and hold the port's outcome to it.

``jnp.asarray`` of each numpy input is what the reference sees, as its own
tests call it: with JAX's 64-bit mode off, float64 arrives as float32 and
int64 as int32.
"""
import importlib

import jax.numpy as jnp

from tests import test_torch_parity_cases as pc

_JNP_DTYPES = {"u8": jnp.uint8, "i8": jnp.int8, "u16": jnp.uint16,
               "i16": jnp.int16, "u32": jnp.uint32, "i32": jnp.int32,
               "f32": jnp.float32, "f64": jnp.float64}


def _resolve(module, name):
    return getattr(importlib.import_module(f"compv_tpu.{module}"), name)


def run_reference(case, oracle: bool = True):
    """The reference's outcome of ``case``; with ``oracle`` its inputs go
    through ``case.ref_inputs`` first (REFERENCE_FAULTS)."""
    fn = _resolve(case.module, case.fn)
    args, kwargs = case.inputs()
    if oracle and case.ref_inputs is not None:
        args, kwargs = case.ref_inputs(args, kwargs)
    args = pc.convert(args, jnp.asarray, _resolve, _JNP_DTYPES.__getitem__)
    kwargs = pc.convert(kwargs, jnp.asarray, _resolve,
                        _JNP_DTYPES.__getitem__)
    return pc.outcome(fn, args, kwargs)


def check(case):
    """The port's outcome on the CPU against the reference's: equal, or,
    for a BY_DESIGN case, still different; a case held to an oracle also
    still differs from the reference's own run (the fault still shows)."""
    got = pc.run_port(case, "cpu")
    diff = pc.compare(run_reference(case), got, case)
    if case.id in pc.BY_DESIGN:
        assert diff, (f"{case.id} no longer differs from the reference: "
                      f"drop its BY_DESIGN entry")
        return
    assert not diff, f"{case.id}: {diff[:3]}"
    if case.ref_inputs is not None:
        assert pc.compare(run_reference(case, oracle=False), got, case), (
            f"{case.id}: the reference's fault no longer shows: drop its "
            f"REFERENCE_FAULTS entry")
