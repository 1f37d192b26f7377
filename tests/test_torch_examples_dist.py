"""The port's distributed_sfm program (``examples_torch/``) against the
reference's (``examples/``), run in the same test.

The reference runs in a subprocess on its virtual 8-device CPU mesh
(``scripts/examples_reference.py``); the port's runs in the test process
with ``--device cpu --ranks 8``: eight gloo ranks spawned by
``parallel.launch.spawn``, 16 frames of 96x128. Held:

* the similarity matrix (16 x 16) exactly, and its printed first row;
* the RMSE before BA as printed, and within 1e-6 relative unprinted (the
  observations are projected in float32 by each package);
* the RMSE after the distributed BA within 5 % or 1e-3 px
  (``tests/test_torch_parallel.py``'s bar for a distributed solve: the
  port adds the ranks' partial sums in rank order, the reference's psum in
  its own order, so the two are not bit-equal);
* at ``--ranks 1`` (no process group) and ``--ranks 2``: 2 and 4 frames,
  whose similarity rows are the first entries of the reference's, exactly,
  and the same RMSE bars (288 observations split evenly at 1, 2 and 8).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "examples_reference", os.path.join(_ROOT, "scripts",
                                       "examples_reference.py"))
er = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(er)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's torch work on one thread here and in the ranks it spawns
    (``OMP_NUM_THREADS``, read by a rank's torch at import), restored
    after: beside the other test workers a many-threaded CPU run stalls on
    its thread pool's barriers (minutes for seconds of work)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    text, calls = er.run_subprocess(
        "distributed_sfm", str(tmp_path_factory.mktemp("dist_ref")))
    return er.parse("distributed_sfm", text), calls


@pytest.fixture(scope="module")
def port8():
    text, result = er.run_port("distributed_sfm",
                               ["--device", "cpu", "--ranks", "8"])
    return er.parse("distributed_sfm", text), er.plain(result)


def _rmse_after_close(got: float, want: float, printed: bool) -> bool:
    slack = 1e-3 if printed else 0.0        # .3f on both sides
    return abs(got - want) <= max(0.05 * abs(want), 1e-3) + slack


def test_distributed_sfm_prints_the_reference_lines(ref, port8):
    want, got = ref[0], port8[0]
    assert want["devices"] == got["devices"] == 8
    assert want["sim_row"] == [0.0, 3.8, 5.9, 7.2, 8.3, 11.4]
    assert got["sim_row"] == want["sim_row"]
    assert got["rmse_before"] == want["rmse_before"]
    assert _rmse_after_close(got["rmse_after"], want["rmse_after"], True)
    assert got["wrote"] == want["wrote"] == []


def test_distributed_sfm_similarity_matrix_equals_the_reference(ref, port8):
    want = np.asarray(ref[1]["sharded_all_pairs_match"][0])
    got = np.asarray(port8[1]["sharded_all_pairs_match"][0])
    assert want.shape == got.shape == (16, 16)
    np.testing.assert_array_equal(got, want)


def test_distributed_sfm_rmse_against_the_reference(ref, port8):
    (w_before, w_after), (g_before, g_after) = (ref[1]["reproj_rmse"],
                                                port8[1]["reproj_rmse"])
    assert g_before == pytest.approx(w_before, rel=1e-6)
    assert _rmse_after_close(g_after, w_after, False)
    assert g_after < 0.01 * g_before


@pytest.mark.parametrize("ranks", [1, 2])
def test_distributed_sfm_fewer_ranks_agree_with_the_reference(ref, ranks):
    text, result = er.run_port("distributed_sfm",
                               ["--device", "cpu", "--ranks", str(ranks)])
    got, want = er.parse("distributed_sfm", text), ref[0]
    assert got["devices"] == ranks
    assert got["sim_row"] == want["sim_row"][:2 * ranks]
    full = np.asarray(ref[1]["sharded_all_pairs_match"][0])
    sim = er.plain(result)["sharded_all_pairs_match"][0]
    np.testing.assert_array_equal(np.asarray(sim),
                                  full[:2 * ranks, :2 * ranks])
    assert got["rmse_before"] == want["rmse_before"]
    w_before, w_after = ref[1]["reproj_rmse"]
    g_before, g_after = result["reproj_rmse"]
    assert g_before == pytest.approx(w_before, rel=1e-6)
    assert _rmse_after_close(g_after, w_after, False)


def test_program_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the program would run on it")
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        er.run_port("distributed_sfm", [])
