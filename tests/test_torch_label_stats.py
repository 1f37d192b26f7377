"""Port parity for the strip label counter (K5): the kernel's twin (what a
CPU tensor runs) against ``compv_tpu``'s Pallas kernel
``strip_label_counts`` run in interpret mode, on label maps from the port's
``label_components``, and the merged strip counts against ``np.bincount``.

Exact on ``used``, ``truncated`` and every slot ``k < used[s]``; the
reference leaves later slots uninitialized, so they are not compared (the
port writes them as 0). The kernel is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Interpret mode: the module fixture replaces ``pl.pallas_call`` with
``functools.partial(pl.pallas_call, interpret=True)`` before the Pallas
wrapper is first traced; nothing in ``compv_tpu`` changes.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compv_tpu_torch.features.ccl import label_components
from compv_tpu_torch.ops.kernels import label_stats

jstats = importlib.import_module("compv_tpu.ops.pallas.label_stats")


@pytest.fixture(scope="module")
def interpret_pallas():
    """``strip_label_counts`` with its ``pallas_call`` in interpret mode."""
    pl = jstats.pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        yield jstats.strip_label_counts


def _labels(seed: int, h: int, w: int, density: float, connectivity: int):
    rs = np.random.default_rng(seed)
    binary = (rs.random((h, w)) < density).astype(np.uint8)
    return label_components(torch.from_numpy(binary), connectivity, 1000)


def _merge(records, used, n_labels: int) -> np.ndarray:
    """Per-label areas from the strip records (defined slots only)."""
    rec = records.numpy()
    area = np.zeros(n_labels, np.int64)
    for s, u in enumerate(used.numpy()):
        np.add.at(area, rec[s, 0, :u], rec[s, 1, :u])
    return area


CASES = [  # (seed, h, w, density, connectivity)
    (0, 16, 96, 0.4, 4),
    (1, 21, 40, 0.5, 8),
    (2, 8, 128, 0.3, 4),
    (3, 13, 7, 0.6, 8),
]


@pytest.mark.parametrize("rounds,strip_rows", [(32, 8), (256, 8), (32, 4),
                                               (256, 4)])
@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
def test_twin_equals_pallas_interpret(interpret_pallas, case, rounds,
                                      strip_rows):
    seed, h, w, density, conn = case
    lbl = _labels(seed, h, w, density, conn)
    rec, used, trunc = label_stats.strip_label_counts(lbl, rounds, strip_rows)
    w_rec, w_used, w_trunc = (np.asarray(a) for a in interpret_pallas(
        jnp.asarray(lbl.numpy()), rounds, strip_rows))
    np.testing.assert_array_equal(used.numpy(), w_used)
    np.testing.assert_array_equal(trunc.numpy(), w_trunc)
    rec = rec.numpy()
    for s, u in enumerate(w_used):
        np.testing.assert_array_equal(rec[s, :, :u], w_rec[s, :, :u])
        assert (rec[s, :, u:] == 0).all()


def test_truncation_happens():
    lbl = _labels(0, 16, 96, 0.4, 4)
    _, used, trunc = label_stats.strip_label_counts(lbl, 32, 8)
    assert trunc.sum() > 0 and (used[trunc == 1] == 32).all()


@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
def test_merged_counts_equal_bincount(case):
    seed, h, w, density, conn = case
    lbl = _labels(seed, h, w, density, conn)
    rec, used, trunc = label_stats.strip_label_counts(lbl, 4096, 8)
    assert trunc.sum() == 0
    flat = lbl.numpy().ravel()
    want = np.bincount(flat[flat >= 0], minlength=h * w)
    np.testing.assert_array_equal(_merge(rec, used, h * w), want)


def test_all_background_and_empty_strip():
    lbl = torch.full((10, 12), -1, dtype=torch.int32)
    lbl[9, 3] = 7
    rec, used, trunc = label_stats.strip_label_counts(lbl, 16, 8)
    assert used.tolist() == [0, 1] and trunc.tolist() == [0, 0]
    assert rec[1, :, 0].tolist() == [7, 1] and rec.shape == (2, 2, 16)


def test_cpu_tensors_run_the_twin():
    before = label_stats.strip_label_counts.launches
    label_stats.strip_label_counts(torch.zeros((4, 4), dtype=torch.int32))
    assert label_stats.strip_label_counts.launches == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros((4, 4)))      # f32
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros((4, 4), dtype=torch.int32),
                                       rounds=0)
