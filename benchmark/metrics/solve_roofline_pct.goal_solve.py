"""The solves' least time on the chip (benchmark.roofline, from the map, the
goal and the sweep count) over the device time of every operation inside
the solve spans, whatever its name."""

from benchmark import readers


def read(run):
    return readers.roofline_pct(run, "planner.solve", 1)
