"""The differential sweep of ``math/*``: element-wise ops at the dtype
edges, matrices, distances, statistics, transforms, fits and PCA:
each case of ``tests/test_torch_parity_cases.py``'s "math" group through
the reference and the port on the CPU (``tests/parity_reference.check``).
Tolerances are the cases' own, each stated beside it in the table.
"""
import pytest
import torch

from tests import test_torch_parity_cases as pc
from tests.parity_reference import check

CASES = pc.cases("math")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test processes share a few cores; one PyTorch thread per
    process for this file, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_port_matches_reference(case):
    check(case)
