"""CUDA-event time of the `ccl` stage's outermost calls in the window
(``ccl_features``: K2a, run records, K3, segmented stats), a page (the
benchmark's span; see probe.py)."""


def read(m):
    ms = m.stage_ms.get("ccl")
    if ms is None or not m.window_frames:
        return None
    return ms / m.window_frames
