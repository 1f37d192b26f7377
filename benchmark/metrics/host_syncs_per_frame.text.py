"""Host reads of device values a page: the program's own counter
(``compv_tpu_torch.profiling.host_syncs``), syncs over calls of
``ccl_features`` plus those of ``mser_detect``, over every call of the
run (warm-up, window and slice). Nothing without a window or where the
program has no such counter."""


def read(m):
    if not m.window_frames:
        return None
    try:
        from compv_tpu_torch.profiling import host_syncs
    except ImportError:
        return None
    counts = host_syncs()
    rows = [counts.get(e) for e in ("ccl_features", "mser_detect")]
    if not all(r and r["calls"] for r in rows):
        return None
    return sum(r["syncs"] / r["calls"] for r in rows)
