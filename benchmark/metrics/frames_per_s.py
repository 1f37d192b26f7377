"""Frames completed per second: every frame of the requests started in
the window, over the time from the window's start to the last completion."""


def read(m):
    done = [r for r in m.requests if r[3]]
    if not done:
        return None
    return sum(r[2] for r in done) / (max(r[1] for r in done) - m.t0)
