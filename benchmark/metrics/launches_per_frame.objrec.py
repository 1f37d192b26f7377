"""Device kernels in the profiler slice, a frame of the slice."""


def read(m):
    if not m.slice:
        return None
    return m.slice["kernels"] / m.slice["frames"]
