"""K2b's share of its roofline: the least time of the calls in the `k2b`
ranges of the profiler slice (``work_text``'s model of each call: 9 bytes
a pixel once, against the card's published peaks) over the device time of
every kernel launched inside those ranges, whatever implements it.
Nothing where the card has no known peaks or the slice linked no kernel
to the stage."""


def read(m):
    if m.slice is None or m.peaks is None:
        return None
    stage = m.slice["by_stage"].get("k2b")
    calls = m.model_calls.get("k2b")
    if not stage or not stage["kernels"] or not calls:
        return None
    from benchmark import work_text
    model = work_text.MODELS[m.models["k2b"]]
    bound_ms = sum(m.roofline.bound(*model(args), m.peaks)["bound_ms"]
                   for args in calls)
    return 100.0 * bound_ms / (stage["device_ns"] / 1e6)
