"""The mean sweep count of the cold volume solves the VolumePlanner
returned (its states' ``iteration``): an exact count."""


def read(run):
    if not run.items:
        return None
    return sum(i["sweeps"] for i in run.items) / len(run.items)
