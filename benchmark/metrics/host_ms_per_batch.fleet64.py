"""A batch's span less the device's busy time inside it: the batch's build
call, the fields' host copy and the lanes' walks."""

from benchmark import readers


def read(run):
    return readers.host_ms(run, "batch")
