"""A request's span less the device's busy time inside it: the Planner
verbs' host work, the field's host copy, the walk and the poses."""

from benchmark import readers


def read(run):
    return readers.host_ms(run, "request")
