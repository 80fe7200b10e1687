"""The share of the traced window in which the device was idle and no span
of the program was open: host work that no span of the program names."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    return program_spans.idle_unspanned_pct(program_spans.read(run, TRACE))
