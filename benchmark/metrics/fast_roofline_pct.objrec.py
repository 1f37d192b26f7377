"""The FAST stage's share of its roofline: the least time of its calls in
the profiler slice (roofline.fast_stage at each level's shape, against
the card's published peaks) over the device time of every kernel launched
inside the stage's ranges, whatever implements it. Nothing where the
card has no known peaks or the slice linked no kernel to the stage."""


def read(m):
    if m.slice is None or m.peaks is None:
        return None
    stage = m.slice["by_stage"].get("fast")
    calls = m.model_calls.get("fast")
    if not stage or not stage["kernels"] or not calls:
        return None
    bound_ms = m.roofline.stage_bound_ms(m.models["fast"], calls, m.peaks)
    return 100.0 * bound_ms / (stage["device_ns"] / 1e6)
