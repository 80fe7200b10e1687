"""The mean length of the program's ``planner3d.compute_path`` span: the
field's two host copies, the walk and the world poses."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    return program_spans.mean_ms([b - a for n, a, b, _ in spans.spans
                                  if n == "planner3d.compute_path"])
