"""The 95th percentile (nearest rank) of per-frame latency over every
request of the traced run's window; a failed request counts as missing
any limit. Read per layer: from one process to the next the host runs
the same Python at a pace that differs by more than an end-to-end bound
on this tail could hold."""
import math


def read(m):
    if not m.requests:
        return None
    lat = sorted((r[1] - r[0]) * 1e3 / r[2] if r[3] else math.inf
                 for r in m.requests)
    return lat[math.ceil(0.95 * len(lat)) - 1]
