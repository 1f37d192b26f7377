"""The slice's wall time in which no kernel, copy or set ran on the
device, as % of the wall."""


def read(m):
    if not m.slice or m.slice["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - m.slice["busy_s"] / m.slice["window_s"])
