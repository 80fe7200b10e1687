"""The lanes' least time on the chip (benchmark.roofline, from the map, each
goal and each lane's sweep count) over the device time of every operation
inside the batch-solve spans, whatever its name."""

from benchmark import readers


def read(run):
    if not run.groups:
        return None
    return readers.roofline_pct(run, "batch.solve", run.groups[0]["lanes"])
