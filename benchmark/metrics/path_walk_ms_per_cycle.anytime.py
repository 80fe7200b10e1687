"""The self time of the program's ``path.walk`` spans a cycle: the
streamline's walk from the robot's pose on the host (native or NumPy), less
the collections inside it, summed over the traced window and divided by its
cycles."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    return program_spans.per_item_ms(sum(spans.self_s("path.walk")), len(run.items))
