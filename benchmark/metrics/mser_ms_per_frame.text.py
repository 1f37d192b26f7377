"""CUDA-event time of the `mser` stage's outermost calls in the window
(``mser_detect``: the ladder with K2b, its sorts, the stability rules), a
page (the benchmark's span; see probe.py)."""


def read(m):
    ms = m.stage_ms.get("mser")
    if ms is None or not m.window_frames:
        return None
    return ms / m.window_frames
