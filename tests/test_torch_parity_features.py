"""The differential sweep of ``features/*``, ``matchers/*`` and
``slam/frontend``: FAST, edges, Canny, CCL, HOG, Hough, MSER, ORB, the
brute-force matcher and the frontend pair on small and degenerate images
and descriptor sets:
each case of ``tests/test_torch_parity_cases.py``'s "features" group through
the reference and the port on the CPU (``tests/parity_reference.check``).
Tolerances are the cases' own, each stated beside it in the table.
"""
import pytest
import torch

from tests import test_torch_parity_cases as pc
from tests.parity_reference import check

CASES = pc.cases("features")


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


def test_fast_detect_ties_at_k_equal_n():
    """FAST's tie order (BY_DESIGN): at max_features = h * w the keypoint
    sets are equal, below it the order is too."""
    from tests.parity_reference import run_reference
    cases = {c.axis: c for c in CASES if c.fn == "fast_detect"}
    for axis in ("k=n", "k=n-1", "k<n"):
        want = run_reference(cases[axis])[1][1]
        got = pc.run_port(cases[axis], "cpu")[1][1]
        rows = [sorted(zip(*(t[k].tolist() for k in ("x", "y", "strength",
                                                       "valid"))))
                for t in (want, got)]
        assert rows[0] == rows[1], axis
        same_order = all((want[k] == got[k]).all() for k in want)
        assert same_order == (axis != "k=n"), axis
