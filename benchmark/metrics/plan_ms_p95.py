"""The 95th percentile of plan latency over every request of the window, from
the new goal to the path's poses returned (host clock)."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run)
