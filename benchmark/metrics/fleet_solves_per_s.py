"""Lanes converged and walked to their goal, over the whole window; the batch
in flight at the close is finished and counted with its time (host clock)."""

from benchmark import readers


def read(run):
    return readers.ok_per_s(run)
