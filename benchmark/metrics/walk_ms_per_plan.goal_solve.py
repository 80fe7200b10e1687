"""The span of ``Planner.compute_path``: the field's host copy, the walk and
the world poses."""

from benchmark import readers


def read(run):
    return readers.span_ms(run, "walker")
