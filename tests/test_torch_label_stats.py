"""Port parity for the strip label counter (K5): the kernel's twin (what a
CPU tensor runs) against ``compv_tpu``'s Pallas kernel
``strip_label_counts`` run in interpret mode, on label maps from the port's
``label_components``, and the merged strip counts against ``np.bincount``.

Exact on ``used``, ``truncated`` and every slot ``k < used[s]``; the
reference leaves later slots uninitialized, so they are not compared (the
port writes them as 0). The kernel is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py); here a numpy model of its
decomposition (run heads, a hash table in front of a buffer, a bounded
sorted list, flushes when the buffer fills) is held against the twin and
the Pallas kernel.

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
from compv_tpu_torch.ops.kernels import _build, label_stats

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
    before = _build.launch_counts()
    label_stats.strip_label_counts(torch.zeros((4, 4), dtype=torch.int32))
    assert _build.launch_counts() == before


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros((4, 4)))      # f32
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        label_stats.strip_label_counts(torch.zeros((4, 4), dtype=torch.int32),
                                       rounds=0)


# ---------------------------------------------------------------------------
# A numpy model of the Hopper kernel's decomposition (csrc/label_stats.cu):
# the strip read as one flat array, ``step`` labels at a time; one (label,
# run length) key where a label differs from its predecessor or a segment of
# ``seg`` labels begins; a hash table of ``slots`` (label, count) slots that
# a key tries ``probes`` times before it goes to the buffer; a sorted list of
# at most cap + 1 (label, pixels before it) pairs; a flush (empty the table
# into the buffer, append the list, sort, combine equal labels by a prefix
# sum, keep the cap + 1 smallest) whenever the buffer could not take another
# step, and at the end.

def _run_keys(flat: np.ndarray, seg: int):
    """(label, run length) of every run head of ``flat``, runs cut at
    multiples of ``seg``."""
    flat = np.maximum(flat, -1)
    pos = np.arange(flat.size)
    brk = np.ones(flat.size, bool)
    brk[1:] = flat[1:] != flat[:-1]
    brk |= pos % seg == 0
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], flat.size)
    head = flat[starts] >= 0
    return list(zip(flat[starts][head].tolist(),
                    (ends - starts)[head].tolist()))


def _table_add(table, slots, probes, label, count):
    """The kernel's table_add: linear probing from a multiplicative hash."""
    slot = ((label * 2654435761) & 0xFFFFFFFF) >> 12
    for _ in range(probes):
        slot &= slots - 1
        if table.setdefault(slot, [label, 0])[0] == label:
            table[slot][1] += count
            return True
        slot += 1
    return False


def _flush(buf, lst, cap, table):
    """The new list from the table's and the buffer's keys and the old
    list; the table is left empty."""
    buf = buf + [tuple(v) for v in table.values()]
    table.clear()
    keys = buf + [(lbl, (lst[k + 1][1] - before) if k < cap else 0)
                  for k, (lbl, before) in enumerate(lst[:-1] if lst and
                                                    lst[-1][0] is None
                                                    else lst)]
    keys.sort()
    new, pixels = [], 0
    for i, (lbl, cnt) in enumerate(keys):
        if i == 0 or keys[i - 1][0] != lbl:
            if len(new) <= cap:
                new.append((lbl, pixels))
            else:
                new.append(None)             # counted, not kept
        pixels += cnt
    distinct = len(new)
    new = [e for e in new if e is not None]
    if distinct <= cap:
        new.append((None, pixels))           # the closing total
    return new


def _run_merge_model(labels: np.ndarray, rounds: int, strip_rows: int,
                     step: int, seg: int = 32, slots: int = 16,
                     probes: int = 2):
    h, w = labels.shape
    n_strips = -(-h // strip_rows)
    cap, buf_keys, _ = label_stats.kernel_plan(rounds, strip_rows, w,
                                               step + slots, slots)
    assert buf_keys >= cap + 1 + step + slots
    assert buf_keys & (buf_keys - 1) == 0
    records = np.zeros((n_strips, 2, rounds), np.int32)
    used = np.zeros(n_strips, np.int32)
    trunc = np.zeros(n_strips, np.int32)
    flushes = 0
    for s in range(n_strips):
        flat = labels[s * strip_rows:(s + 1) * strip_rows].reshape(-1)
        buf, lst, table = [], [], {}

        def n_list():
            return len(lst) - (1 if lst and lst[-1][0] is None else 0)

        for base in range(0, flat.size, step):
            if len(buf) + n_list() + step + slots > buf_keys:
                lst, buf = _flush(buf, lst, cap, table), []
                flushes += 1
            buf += [key for key in _run_keys(flat[base:base + step], seg)
                    if not _table_add(table, slots, probes, *key)]
            assert len(buf) + len(table) + n_list() <= buf_keys
        lst = _flush(buf, lst, cap, table)
        nl = n_list()
        assert nl <= cap + 1
        u = min(nl, rounds)
        for r in range(u):
            records[s, 0, r] = lst[r][0]
            records[s, 1, r] = lst[r + 1][1] - lst[r][1]
        used[s], trunc[s] = u, nl > rounds
    return records, used, trunc, flushes


MODEL_CASES = {  # name: (labels, strip_rows)
    "components_16x96": lambda: (_labels(0, 16, 96, 0.4, 4).numpy(), 8),
    "components_21x40_rows_4": lambda: (_labels(1, 21, 40, 0.5, 8).numpy(), 4),
    "components_13x7": lambda: (_labels(3, 13, 7, 0.6, 8).numpy(), 8),
    "long_runs_8x300": lambda: (np.repeat(np.random.default_rng(5).integers(
        -1, 9, (8, 20)), 15, axis=1).astype(np.int32), 8),
    "per_pixel_distinct": lambda: (np.arange(16 * 70, dtype=np.int32)
                                   .reshape(16, 70)[:, ::-1].copy(), 8),
    "random_labels": lambda: (np.random.default_rng(6).integers(
        -2, 40, (24, 133)).astype(np.int32), 8),
    "all_background": lambda: (np.full((10, 12), -1, np.int32), 8),
    "wide_8x5000": lambda: (_labels(7, 8, 5000, 0.45, 8).numpy(), 8),
}


@pytest.mark.parametrize("step,slots,probes", [(32, 16, 2), (96, 4, 1),
                                               (2048, 1024, 4),
                                               (2048, 16, 0)])
@pytest.mark.parametrize("rounds", [1, 8, 256])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_run_merge_model_equals_twin(case, rounds, step, slots, probes):
    """Run heads + hash table + chunked bounded merge, for steps that split
    runs and force flushes, tables that overflow and none at all, rounds
    that truncate and do not, a strip wider than 4096: every output equals
    the twin's, slot for slot."""
    labels, strip_rows = MODEL_CASES[case]()
    rec, used, trunc, flushes = _run_merge_model(labels, rounds, strip_rows,
                                                 step, 32, slots, probes)
    want = label_stats.strip_label_counts_ref(torch.from_numpy(labels),
                                              rounds, strip_rows)
    np.testing.assert_array_equal(used, want[1].numpy())
    np.testing.assert_array_equal(trunc, want[2].numpy())
    np.testing.assert_array_equal(rec, want[0].numpy())
    if case == "per_pixel_distinct" and step == 32:
        assert flushes > 0 and (trunc.sum() > 0) == (rounds < 560)


@pytest.mark.parametrize("seg", [4, 32])
@pytest.mark.parametrize("rounds,strip_rows", [(8, 8), (256, 4)])
@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
def test_run_merge_model_equals_pallas_interpret(interpret_pallas, case,
                                                 rounds, strip_rows, seg):
    seed, h, w, density, conn = case
    lbl = _labels(seed, h, w, density, conn).numpy()
    rec, used, trunc, _ = _run_merge_model(lbl, rounds, strip_rows, 64, seg)
    w_rec, w_used, w_trunc = (np.asarray(a) for a in interpret_pallas(
        jnp.asarray(lbl), rounds, strip_rows))
    np.testing.assert_array_equal(used, w_used)
    np.testing.assert_array_equal(trunc, w_trunc)
    for s, u in enumerate(w_used):
        np.testing.assert_array_equal(rec[s, :, :u], w_rec[s, :, :u])


def test_twin_takes_strips_past_the_old_kernel_width():
    """8 x 8192 and 16 x 4096 labels a strip (65,536: twice what the first
    kernel's shared memory held) on the twin, merged against bincount."""
    lbl = _labels(9, 16, 8192, 0.45, 8)
    for strip_rows, width in ((8, 8192), (16, 4096)):
        sub = lbl[:, :width].contiguous()
        rec, used, trunc = label_stats.strip_label_counts(sub, 4096,
                                                          strip_rows)
        assert trunc.sum() == 0
        flat = sub.numpy().ravel()
        want = np.bincount(flat[flat >= 0], minlength=16 * 8192)
        np.testing.assert_array_equal(_merge(rec, used, 16 * 8192), want)


def test_kernel_plan_bounds_the_list():
    """The list is min(rounds, strip pixels) + 1 pairs; the buffer the power
    of two that takes it and one step."""
    assert label_stats.kernel_plan(256, 8, 1122, 3072, 1024) == (256, 4096,
                                                                 43016)
    assert label_stats.kernel_plan(4096, 8, 16, 3072, 1024)[0] == 128
    cap, buf, smem = label_stats.kernel_plan(11519, 8, 8192, 3072, 1024)
    assert (cap, buf) == (11519, 16384) and smem + 1024 <= 232448
    assert label_stats.kernel_plan(11520, 8, 8192, 3072, 1024)[2] + 1024 \
        > 232448
