"""Requests completed with a converged field and a path to the goal, over the
whole window (host clock)."""

from benchmark import readers


def read(run):
    return readers.ok_per_s(run)
