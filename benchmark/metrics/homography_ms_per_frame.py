"""CUDA-event time of the `homography` stage's outermost calls in the window,
a frame (the benchmark's span; see probe.py)."""


def read(m):
    ms = m.stage_ms.get("homography")
    if ms is None or not m.window_frames:
        return None
    return ms / m.window_frames
